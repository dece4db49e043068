"""Every CLI of the PyTorch port accepts the options of its JAX counterpart.

Each CLI builds its parser inside main(); the test stops main() at
parse_args (a patched ArgumentParser.parse_args raises with the parser) and
compares the option strings of the two parsers. The differences the port
keeps on purpose are listed with their reasons in ALLOWED; any other option
that one side has and the other lacks fails.
"""
import argparse
import importlib
import importlib.util
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_CLI = "ratio_guided_multimodal_fm_tpu.cli."
PORT_CLI = "ratio_guided_multimodal_fm_tpu_torch.cli."

# (JAX main, port main) of every CLI of both packages; the two demos are
# scripts in the JAX package and CLIs in the port
PAIRS = {
    name: (JAX_CLI + name, PORT_CLI + name)
    for name in ("sample", "sample_mnist_svhn", "evaluate",
                 "evaluate_mnist_svhn", "train_flow", "train_flow_mnist32",
                 "train_flow_svhn", "train_ratio", "train_ratio_mnist_svhn",
                 "train_classifier", "train_classifiers_mnist_svhn",
                 "reflow", "serve")}
PAIRS["config5_demo"] = (ROOT / "scripts" / "config5_demo.py",
                         PORT_CLI + "config5_demo")
PAIRS["stretch64_demo"] = (ROOT / "scripts" / "stretch64_demo.py",
                           PORT_CLI + "stretch64_demo")

# option -> reason, by CLI: (only in JAX, only in the port)
ALLOWED = {
    "config5_demo": ({"--platform": "JAX picks its backend by platform name; "
                                    "the port's device flag is --device"},
                     {"--device": "the port's device flag (cuda or cpu), in "
                                  "place of JAX's --platform"}),
    "train_flow": ({}, {"--latents": "the port's class-conditional SiT "
                                     "(--model sit_xl_2|sit_s_2) trains on "
                                     "pre-extracted latents and labels; the "
                                     "JAX package has no SiT"}),
    "stretch64_demo": ({}, {"--model_channels": "the port's demo takes the "
                                                "U-Net width, so that the CPU "
                                                "tests run it narrow",
                            "--device": "the port's device flag (cuda or "
                                        "cpu); JAX's script runs where JAX "
                                        "puts it"}),
}


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parser built")
        self.parser = parser


def _main_of(target):
    if isinstance(target, pathlib.Path):
        spec = importlib.util.spec_from_file_location(
            f"_jax_script_{target.stem}", target)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main
    return importlib.import_module(target).main


def _parser(target, monkeypatch) -> argparse.ArgumentParser:
    """The parser that target's main() builds."""
    def stop(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    main = _main_of(target)
    with pytest.raises(_Parsed) as caught:
        if isinstance(target, pathlib.Path):
            main()
        else:
            main([])
    monkeypatch.undo()
    return caught.value.parser


def _options(target, monkeypatch) -> dict:
    """{option string: its action} of target's parser."""
    return {opt: act for act in _parser(target, monkeypatch)._actions
            for opt in act.option_strings}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_port_cli_accepts_the_jax_options(name, monkeypatch):
    jax_target, port_target = PAIRS[name]
    jax_opts = _options(jax_target, monkeypatch)
    port_opts = _options(port_target, monkeypatch)
    only_jax, only_port = ALLOWED.get(name, ({}, {}))
    missing = set(jax_opts) - set(port_opts) - set(only_jax)
    extra = set(port_opts) - set(jax_opts) - set(only_port)
    assert not missing, f"{name}: the port refuses the JAX options {missing}"
    assert not extra, f"{name}: the port has options JAX lacks: {extra}"
    # each allowed difference is still a difference (else drop it above)
    assert not set(only_jax) & set(port_opts)
    assert not set(only_port) & set(jax_opts)
    # a switch stays a switch, an option that takes a value takes one
    for opt in set(jax_opts) & set(port_opts):
        assert (jax_opts[opt].nargs == 0) == (port_opts[opt].nargs == 0), opt


@pytest.mark.parametrize("name", ["sample", "sample_mnist_svhn", "evaluate",
                                  "evaluate_mnist_svhn", "train_flow",
                                  "train_ratio", "reflow", "serve"])
def test_common_flags_parse(name, monkeypatch):
    """--data_root and --no_prefetch parse on the CLIs that once refused
    them, with JAX's defaults."""
    _, port_target = PAIRS[name]
    parser = _parser(port_target, monkeypatch)
    base = ["--modality", "x"] if name == "train_flow" else []
    defaults = parser.parse_args(base)
    assert defaults.data_root == "./data" and defaults.no_prefetch is False
    args = parser.parse_args(base + ["--data_root", "/elsewhere",
                                     "--no_prefetch"])
    assert args.data_root == "/elsewhere" and args.no_prefetch is True
