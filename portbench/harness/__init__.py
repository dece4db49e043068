"""The benchmark's own machinery: the cell's files, seeds, weights made on
the device, the window, the profiler trace and its arithmetic, the frozen
counts, the comparisons that decide `correct`. It imports the program
only in `drivers/` and never JAX or the JAX package."""
