"""Shared CLI plumbing (port of the parts of cli/common.py the sampler,
evaluation, train, reflow and serve CLIs need): flag groups (--smc_*
included), the runtime set-up (device, multi-process join, refusals), the
data-parallel adaptation of a train step (`multihost_adapt`), the ratio
train CLIs' body (plain or fused), model factory, checkpoint names and
loading, NHWC closures over the NCHW models (merged-pair evaluation
included), diagnostics."""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.core.device import resolve_device
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG
from ratio_guided_multimodal_fm_tpu_torch.core.dtypes import dtype_from_name
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import make_time_grid
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlowMatchingModel,
    FlowMatchingUNet,
)
from ratio_guided_multimodal_fm_tpu_torch.models.ratio import BatchNorm2d
from ratio_guided_multimodal_fm_tpu_torch.parallel.multihost import (
    DataParallel,
    globalize_batch,
    maybe_init_distributed,
    multi_process_requested,
    process_device,
    process_info,
)
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (  # noqa: F401
    checkpoint_path,   # the CLIs take it from here
    ema_checkpoint_path,
    ema_state_dict,
    load_params,
    save_checkpoint,
    wait_for_saves,
)
from ratio_guided_multimodal_fm_tpu_torch.train.loop import (
    epoch_data_iter,
    finish_preemptible,
    restore_preempt,
    train_epochs,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    create_ratio_state,
    make_ratio_train_multistep,
    make_ratio_train_step,
)
_EXPORT_HINT = ("Export it from a JAX checkpoint: python -m "
                "ratio_guided_multimodal_fm_tpu.cli.export_torch "
                "--checkpoint {ckpt} --model {model} --out {path}")


# every sampling method of the sample, evaluate and serve CLIs
METHODS = ("none", "mc_feng", "grad", "mc_feng+grad", "smc")


def add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (default; fails without a "
                        "GPU) or 'cpu'")
    p.add_argument("--seed", type=int, default=42,
                   help="Random seed for reproducibility")
    p.add_argument("--data_root", type=str, default="./data",
                   help="Dataset root (IDX/.mat files; synthetic fallback)")
    p.add_argument("--dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="Model activation dtype (params stay f32; guidance "
                        "weight math is always f32)")
    p.add_argument("--merged_unet", action="store_true",
                   help="evaluate the two velocity nets as one merged "
                        "grouped-conv network (models/merged.py; same math) "
                        "where their topologies match. Off by default, as "
                        "in the JAX package (PERF.md has the card's "
                        "timing)")
    # multi-process runs (parallel/multihost.py); single-process unless a
    # coordinator and more than one process are given (the variables
    # RGMF_COORDINATOR / RGMF_NUM_PROCESSES / RGMF_PROCESS_ID work too)
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0 (multi-process runs)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total number of processes")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in [0, num_processes)")
    p.add_argument("--no_prefetch", action="store_true",
                   help="accepted for the JAX CLIs' sake: the port keeps "
                        "the dataset on the device and has no prefetch "
                        "thread to turn off")


def add_solver_flag(p: argparse.ArgumentParser):
    """--solver / --time_grid / --grid_power (flow/cfm.py)."""
    p.add_argument("--solver", type=str, default="euler",
                   choices=["euler", "midpoint", "heun"],
                   help="ODE integrator: 'euler' (reference protocol), "
                        "'midpoint' (2 evals/step, 2nd order; composes "
                        "with guidance), 'heun' (2nd order, unguided only)")
    p.add_argument("--time_grid", type=str, default="uniform",
                   choices=["uniform", "late", "early", "cosine"],
                   help="ODE step placement (flow/cfm.py:make_time_grid)")
    p.add_argument("--grid_power", type=float, default=2.0,
                   help="warp exponent for --time_grid late/early")


def add_grad_flags(p: argparse.ArgumentParser):
    """--grad_strength / --grad_scale / --grad_t_max: the grad term of the
    'grad' and 'mc_feng+grad' methods (sample/guided.py)."""
    p.add_argument("--grad_strength", type=float, default=None,
                   help="Separate strength for the grad term "
                        "(default: guidance_strength)")
    p.add_argument("--grad_scale", type=str, default="const",
                   choices=["const", "sigma"],
                   help="grad term scaling: const or sigma_t^2")
    p.add_argument("--grad_t_max", type=float, default=1.0,
                   help="gate the grad term to t < grad_t_max")


def add_mc_refresh_flag(p: argparse.ArgumentParser):
    """--mc_refresh K: fresh MC sets along each trajectory."""
    p.add_argument("--mc_refresh", type=int, default=1,
                   help="ABLATION ONLY (the JAX package measured it "
                        "harmful). K>1 regenerates the N_mc set every "
                        "num_steps/K steps (mc_feng methods); with K>1 the "
                        "evaluation chunk policy drops to 1 chunk. 1 = "
                        "reference protocol (keep it).")


def add_smc_flags(p: argparse.ArgumentParser):
    """--smc_* of the SMC (particle-filter) guidance method (sample/smc.py):
    Langevin churn and systematic resampling on the ratio potential."""
    p.add_argument("--smc_churn", type=float, default=1.0,
                   help="Langevin churn coefficient (beta_t = churn*(1-t)^2;"
                        " regenerates diversity after resampling; 0 = "
                        "deterministic ODE proposal)")
    p.add_argument("--smc_churn_iters", type=int, default=1,
                   help="Langevin iterations per ODE step: >1 adds pure "
                        "marginal-preserving mixing iterations at t+dt (two "
                        "velocity evaluations each)")
    p.add_argument("--smc_resample_tau", type=float, default=0.5,
                   help="systematic-resample when the ESS < tau*B")
    p.add_argument("--smc_t_min", type=float, default=0.2,
                   help="no resampling before this t (early endpoint "
                        "predictions are off-distribution for the "
                        "terminal-time ratio net)")
    p.add_argument("--smc_t_max", type=float, default=0.9,
                   help="no resampling after this t (leave churn time to "
                        "decorrelate resampled clones)")
    p.add_argument("--smc_resample_window", type=str, default="t",
                   choices=["t", "step"],
                   help="'t' gates resampling on raw time, 'step' on the "
                        "step fraction i/num_steps (the same on the uniform "
                        "grid; keeps the number of eligible steps under a "
                        "non-uniform --time_grid). Read by the evaluation "
                        "CLIs only, as in the JAX package")
    p.add_argument("--smc_group", type=int, default=16,
                   help="island size: particles resample within "
                        "independent groups of this size (0 = one global "
                        "population; a non-dividing batch is padded with "
                        "phantoms)")


def smc_config_from_args(args, strength: float, x_shape, y_shape):
    """An SMCSamplerConfig from the CLI flags (JAX cli/common.py)."""
    from ratio_guided_multimodal_fm_tpu_torch.sample.smc import (
        SMCSamplerConfig,
    )

    return SMCSamplerConfig(
        guidance_strength=strength, num_steps=args.num_steps,
        x_shape=tuple(x_shape), y_shape=tuple(y_shape),
        churn=args.smc_churn,
        churn_iters=getattr(args, "smc_churn_iters", 1),
        resample_tau=args.smc_resample_tau,
        resample_t_min=args.smc_t_min, resample_t_max=args.smc_t_max,
        resample_group=args.smc_group,
        resample_window=getattr(args, "smc_resample_window", "t"),
        log_ratio_clip=getattr(args, "ratio_clip", None),
        solver=args.solver, time_grid=args.time_grid,
        grid_power=args.grid_power)


def sample_smc_from_args(args, fm_x, fm_y, log_ratio, x_shape, y_shape,
                         generator):
    """The sample CLIs' SMC call: (x1, y1, diags) of args.num_samples pairs.
    Like the JAX CLIs they pass every --smc_* flag on but
    --smc_resample_window, so their SMC keeps the 't' window (ROADMAP F6)."""
    import dataclasses

    from ratio_guided_multimodal_fm_tpu_torch.sample.smc import (
        make_smc_sampler,
    )

    cfg = dataclasses.replace(smc_config_from_args(
        args, args.guidance_strength, x_shape, y_shape), resample_window="t")
    return make_smc_sampler(fm_x, fm_y, cfg, log_ratio)(generator,
                                                        args.num_samples)


def add_eval_flags(p: argparse.ArgumentParser):
    """--eval_chunks / --auto_chunks / --fid of the evaluation CLIs
    (eval/chunked.py, eval/fid.py)."""
    from ratio_guided_multimodal_fm_tpu_torch.eval.chunked import (
        DEFAULT_AUTO_CHUNKS,
    )

    p.add_argument("--eval_chunks", type=str, default="auto",
                   help="'auto' (default): chunked sampling with a FRESH "
                        "MC set per chunk (eval/chunked.py); an integer "
                        "forces that many chunks (1 = one shared set)")
    p.add_argument("--auto_chunks", type=int, default=DEFAULT_AUTO_CHUNKS,
                   help="Number of chunks in 'auto' mode (default 4)")
    p.add_argument("--fid", action="store_true",
                   help="Also compute classifier-FID vs real data (the "
                        "eval classifier's fc1 features, not Inception)")


def add_reflow_flag(p: argparse.ArgumentParser):
    """--reflow: load the reflow-distilled flows (a `_reflow` name part)."""
    p.add_argument("--reflow", action="store_true",
                   help="use the reflow-distilled flows "
                        "(checkpoints/flow_*_reflow_best.pth)")


def add_ema_flag(p: argparse.ArgumentParser):
    """--ema selects the EMA flow weights, --ratio_ema the EMA ratio
    weights (an `_ema` name part before `best`)."""
    p.add_argument("--ratio_ema", action="store_true",
                   help="load EMA ratio-estimator weights "
                        "(ratio_*_ema_best.pth)")
    p.add_argument("--ema", action="store_true",
                   help="load the EMA (Polyak-averaged) flow checkpoints "
                        "(flow_*_ema_best.pth)")


def add_fused_flag(p: argparse.ArgumentParser):
    """--fused_steps of the train CLIs (train/steps.py:
    make_fm_train_multistep / make_ratio_train_multistep)."""
    p.add_argument("--fused_steps", type=int, default=1,
                   help="Run K optimizer steps per dispatch over the "
                        "dataset held on the device: on the card one CUDA "
                        "graph replay per K steps (the JAX package's "
                        "lax.scan program). Single-process only. The "
                        "random stream differs from a K=1 run of the same "
                        "seed (per-sub-step seeds), trailing batches that "
                        "do not fill a K-chunk are dropped, and preemption "
                        "granularity becomes K steps. 1 = reference "
                        "protocol.")


def add_fast_rng_flag(p: argparse.ArgumentParser):
    """--fast_rng of the train CLIs, refused by init_runtime: it switches
    JAX's PRNG implementation, which has no counterpart in torch."""
    p.add_argument("--fast_rng", action="store_true",
                   help="JAX only (its RngBitGenerator keys); refused here")


def add_ratio_train_flags(p: argparse.ArgumentParser):
    """The flags both ratio-net train CLIs share (JAX train_ratio.py and
    train_ratio_mnist_svhn.py), with the common flags."""
    p.add_argument("--loss_type", type=str, default="disc",
                   choices=["disc", "rulsif"])
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--real_fake_ratio", type=float, default=0.5)
    p.add_argument("--ema_decay", type=float, default=None,
                   help="Maintain a Polyak (EMA) average of the ratio "
                        "params; every best save writes a ratio_*_ema_best "
                        "sibling (EMA params + the current BatchNorm "
                        "statistics) loadable with --ratio_ema")
    p.add_argument("--preempt_path", type=str, default=None,
                   help="Preemption-safe training: on SIGTERM, save a "
                        "step-granular resumable checkpoint here and exit; "
                        "if it exists at startup, resume from it")
    add_fused_flag(p)
    add_fast_rng_flag(p)
    add_common_flags(p)


def run_ratio_training(args, model: torch.nn.Module, loader, device,
                       ckpt_name, index_loader=None, **loss_kwargs):
    """The ratio train CLIs' body: clip(1.0)+Adam(--lr) with the optional
    EMA, a preempted run restored, --epochs through the epoch driver
    (patience 5, a periodic save every 10 epochs, early stopping on the
    mean loss), the best and periodic weights written as bare
    reference-layout state dicts `ckpt_name(part)` (with BatchNorm buffers)
    and, with an EMA, the `_ema` sibling of the best (train/checkpoint.py:
    ema_state_dict). With --fused_steps K > 1, `index_loader()` gives
    (x_all, y_all, chunk loader) and each driver step is a fused K-step
    macro step; multi-process runs train data-parallel (multihost_adapt).
    Returns (state, best, history)."""
    state = create_ratio_state(model, device, lr=args.lr,
                               ema_decay=args.ema_decay)
    print(f"Model parameters: {count_params(state.model):,}")
    state, resume = restore_preempt(args.preempt_path, state)
    if resume["start_epoch"] or resume["start_step"]:
        print(f"Resuming preempted run: epoch {resume['start_epoch']}, "
              f"step {resume['start_step']} "
              f"(best {resume['start_best']:.4f})")

    def save_best(s, epoch, best):
        path = ckpt_name("best")
        save_checkpoint(path, s.model.state_dict(), async_save=True)
        print(f"  -> Saved best model: {path}")
        if s.ema is not None:
            save_checkpoint(ema_checkpoint_path(path), ema_state_dict(s),
                            async_save=True)
            print(f"  -> Saved EMA model: {ema_checkpoint_path(path)}")

    def save_periodic(s, epoch, best):
        save_checkpoint(ckpt_name(f"epoch{epoch}"), s.model.state_dict(),
                        async_save=True)

    if args.fused_steps > 1:
        x_all, y_all, loader = index_loader()
        fused = make_ratio_train_multistep(args.loss_type,
                                           ema_decay=args.ema_decay,
                                           **loss_kwargs)

        def step_fn(s, b, g):
            return fused(s, x_all, y_all, b["xidx"], b["yidx"],
                         b["is_real"], g)

        print(f"Fused dispatch: {args.fused_steps} steps/program, "
              f"{len(loader)} programs/epoch (epoch logs count programs)")
        data_iter = epoch_data_iter(loader)
    else:
        step = make_ratio_train_step(args.loss_type,
                                     ema_decay=args.ema_decay, **loss_kwargs)
        state, step_fn, extract = multihost_adapt(
            state, lambda s, b, g: step(s, b["x"], b["y"], b["is_real"], g),
            lambda b: b)
        data_iter = epoch_data_iter(loader, extract)

    state, best, history = train_epochs(
        state, step_fn, data_iter, args.epochs, RNG(args.seed + 1, device),
        loss_key="loss", save_best_fn=save_best,
        save_periodic_fn=save_periodic, save_every=10, patience=5,
        preempt_path=args.preempt_path, **resume)
    if not finish_preemptible(history, args.preempt_path):
        wait_for_saves()
        print("\nTraining complete!")
        print(f"Best loss: {best:.4f}")
    return state, best, history


def arm_preemption():
    """Train-CLI startup hook: route SIGTERM to the preemption flag so a
    signal that lands before the epoch driver's guard (data loading,
    model set-up, the kernels' build) is honoured at the first completed
    step. Only the train CLIs call it: they always reach the driver, which
    consumes the flag; elsewhere SIGTERM must keep killing the process."""
    from ratio_guided_multimodal_fm_tpu_torch.train.preemption import arm
    arm()


def init_runtime(args, training: bool = True) -> torch.device:
    """Every CLI's runtime set-up (JAX init_runtime): refuse what has no
    meaning here, join the other processes of a multi-process run
    (--coordinator_address, --num_processes, --process_id or their
    RGMF_* variables; a no-op otherwise) and resolve this rank's device
    (`cuda` unless --device cpu; float32 pinned). --fused_steps > 1 is
    single-process only, as in JAX. The train CLIs (`training`) say that
    --dtype does not apply to them."""
    if getattr(args, "fast_rng", False):
        raise SystemExit("--fast_rng selects JAX's RngBitGenerator PRNG; it "
                         "has no meaning in torch, whose generators are "
                         "Philox on the card (drop the flag)")
    flags = (getattr(args, "coordinator_address", None),
             getattr(args, "num_processes", None),
             getattr(args, "process_id", None))
    if getattr(args, "fused_steps", 1) > 1 and multi_process_requested(
            *flags):
        raise SystemExit("--fused_steps > 1 is single-process only "
                         "(multi-process DP shards host batches)")
    if training and getattr(args, "dtype", "f32") != "f32":
        print("--dtype is ignored by training, which runs in float32 as "
              "the JAX package's train CLIs do")
    device = resolve_device(args.device)
    maybe_init_distributed(*flags, device=device)
    return process_device(device)


def multihost_adapt(state, step_fn, extract):
    """Adapt a (state, step, batch-extract) triple for multi-process data
    parallelism (JAX multihost_adapt). Single-process: returned unchanged.
    Multi-process: checks that every rank starts from the same parameters
    (identical seeds), gives the state a DataParallel (the steps then
    draw for the global batch and keep their rows, take their share of the
    global loss and sum the gradients over the ranks; models/ratio.py's
    BatchNorm uses the global batch's statistics), and makes each batch
    this rank's contiguous rows of the identically seeded global batch."""
    if process_info()[1] == 1:
        return state, step_fn, extract
    dp = DataParallel()
    dp.assert_replicated(list(state.model.state_dict().values()))
    state.dp = dp
    for m in state.model.modules():
        if isinstance(m, BatchNorm2d):
            m.dp = dp
    return state, step_fn, lambda b: globalize_batch(extract(b))


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def dtype_of(args) -> torch.dtype:
    return dtype_from_name(getattr(args, "dtype", "f32"))


def fm_model(kind: str, dtype: torch.dtype = torch.float32):
    """'--model unet|original' factory (ref sample.py:132-134): the MNIST-28
    FlowMatchingUNet or the encoder-decoder FlowMatchingModel."""
    if kind == "unet":
        return FlowMatchingUNet(dtype=dtype)
    return FlowMatchingModel(dtype=dtype)


def fm_bridge(kind: str) -> str:
    """The weight-bridge name of a '--model' kind (the JAX exporter's
    --model), for the missing-checkpoint hint."""
    return "unet_mnist" if kind == "unet" else "fm_original"


def load_state_dict(model: torch.nn.Module, path: str, model_kind: str):
    """Strict-load a reference-layout .pth (a bare state dict or a
    {'model_state_dict': ...} training dict) into `model`. A missing file
    exits (SystemExit, as the JAX CLIs' load_params_or_exit) with the
    export command that writes it."""
    if not os.path.exists(path):
        raise SystemExit(
            f"ERROR: checkpoint not found: {path}\n" + _EXPORT_HINT.format(
                ckpt=path[:-len(".pth")], model=model_kind, path=path))
    return load_params(path, model)


def classifier_fn(model):
    """NHWC images (numpy or a tensor) -> logits on the classifier's
    device, without autograd."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def fn(x):
        return model(torch.as_tensor(x).to(device, torch.float32))
    return fn


def velocity_fn(model):
    """(x NHWC, t [B]) -> v NHWC through an NCHW velocity net. On the card
    the NCHW view of an NHWC tensor is `channels_last`, so no copy."""
    def fn(x, t):
        return model(x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1).contiguous()
    return fn


def maybe_merged_pair_fn(model_x, model_y, args=None):
    """(x, y, t) -> (v_x, v_y) NHWC evaluating both nets as one merged
    network (models/merged.py) when the user passed --merged_unet and the
    topologies match; None otherwise. The weights are merged once, here.
    Same math either way; the default stays off, as in the JAX package."""
    if args is None or not getattr(args, "merged_unet", False):
        return None
    from ratio_guided_multimodal_fm_tpu_torch.models.merged import (
        can_merge,
        merged_pair_apply,
    )

    if not can_merge(model_x, model_y):
        return None
    return merged_pair_apply(model_x)(model_x, model_y)


def ratio_log_fn(model):
    """(x NHWC, y NHWC) -> log r̂ [B] through an NCHW ratio net."""
    def fn(x, y):
        return model.log_ratio(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))
    return fn


def summarize_diagnostics(diags, num_steps: int, time_grid: str = "uniform",
                          grid_power: float = 2.0) -> list:
    """Per-step summary rows from stacked diagnostics ([T] or [T, B])."""
    if not diags:
        return []
    ts = make_time_grid(num_steps, time_grid, grid_power)[0]
    d = {k: v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
         else np.asarray(v) for k, v in diags.items()}
    rows = []
    for s in range(num_steps):
        row = {"step": s, "t": round(float(ts[s]), 4)}
        for k, v in sorted(d.items()):
            if v.ndim == 0:
                continue
            if v.ndim == 1:
                row[k] = float(v[s])
            else:
                row[f"{k}_mean"] = float(v[s].mean())
                row[f"{k}_min"] = float(v[s].min())
        rows.append(row)
    return rows


def report_guidance_diagnostics(diags, num_steps: int, save_path=None,
                                log_fn=print, time_grid: str = "uniform",
                                grid_power: float = 2.0) -> list:
    """Print guidance diagnostics at ~30% marks (ESS → 1 is the weight
    collapse) and optionally save the per-step trace as JSON."""
    rows = summarize_diagnostics(diags, num_steps, time_grid, grid_power)
    if not rows:
        return rows
    stride = max(1, int(0.3 * num_steps))
    for s in range(stride, num_steps, stride):
        r = rows[s]
        parts = [f"t={r['t']:.2f}"]
        if "ess_mean" in r:
            parts.append(f"ESS mean={r['ess_mean']:.1f} "
                         f"min={r['ess_min']:.1f}")
        if "smc_ess" in r:
            # 'resampled' is 0/1 in global mode and the fraction of the
            # islands that resampled in island mode: a float
            parts.append(f"SMC-ESS={r['smc_ess']:.1f}"
                         f" resampled={r.get('resampled', 0.0):.2f}")
        for k in ("v_x_norm", "v_y_norm", "g_x_norm", "g_y_norm"):
            if k in r:
                parts.append(f"{k.replace('_norm', '')}||={r[k]:.3f}")
        if "w_max" in r:
            parts.append(f"w∈[{r.get('w_min', 0):.2e},{r['w_max']:.2e}]")
        if "Z_bar_mean" in r:
            parts.append(f"Z̄={r['Z_bar_mean']:.3e}")
        log_fn("  [guidance diag] " + "  ".join(parts))
    if save_path:
        with open(save_path, "w") as f:
            json.dump(rows, f, indent=1)
        log_fn(f"  Diagnostics trace saved to: {save_path}")
    return rows
