"""The benchmark's plain reference: the nets, the guided sampler's step and
the training steps in plain PyTorch (float32, TF32 off), written from the
published architecture and kept apart from the program under test. It
imports torch and numpy only: nothing of the port, of JAX or of the JAX
package."""
