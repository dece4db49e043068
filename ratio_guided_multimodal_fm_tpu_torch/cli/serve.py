"""HTTP service for guided pair generation (port of cli/serve.py).

Loads the flows and the ratio net once, draws the MC candidate set once at
start-up, runs one batch of each warmed method (which also builds the CUDA
kernels, compiled at first use), and serves

    POST /sample   {"num_samples": 32, "guidance_method": "mc_feng",
                    "guidance_strength": 0.5, "seed": 0, "format": "npz"|"png"}
    GET  /healthz  -> {"status": "ok", "compiled": [...], "batch_size": ...,
                       "stats": {...}}

on 127.0.0.1. Requests are padded to the fixed batch size by repeating
their first row; same-(method, strength) requests that arrive within
`linger_ms` of each other share one dispatch. A request's initial noise
comes from generators on the device seeded derive_seed(seed, 0) (x) and
derive_seed(seed, 1) (y), so the same seed gives the same samples however
it was batched. A failed dispatch is reported to each of its requests
(HTTP 500 with the error).

    python -m ratio_guided_multimodal_fm_tpu_torch.cli.serve \\
        --experiment mnist_svhn --port 8800 --batch_size 64
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    METHODS,
    add_common_flags,
    add_ema_flag,
    add_reflow_flag,
    add_smc_flags,
    add_solver_flag,
    dtype_of,
    maybe_merged_pair_fn,
    ratio_log_fn,
    init_runtime,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.cli.sample import (
    load_exp1_flows,
    load_exp1_ratio,
)
from ratio_guided_multimodal_fm_tpu_torch.cli.sample_mnist_svhn import (
    load_mnist_svhn_models,
)
from ratio_guided_multimodal_fm_tpu_torch.core.device import resolve_device
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    MC_METHODS,
    GuidedSamplerConfig,
    generate_mc_set,
    make_guided_sampler_p,
)
from ratio_guided_multimodal_fm_tpu_torch.sample.smc import (
    SMCSamplerConfig,
    make_smc_sampler,
)

class _WorkItem:
    """One pending /sample request inside the coalescing queue."""

    __slots__ = ("n", "method", "strength", "seed", "event", "result",
                 "error", "batched_with")

    def __init__(self, n, method, strength, seed):
        self.n = n
        self.method = method
        self.strength = strength
        self.seed = seed
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.batched_with = 1


class SamplerService:
    """Owns the samplers, the warm MC set and the coalescing dispatcher.

    fm_*_fn(x NHWC, t [B]) -> v and log_ratio_fn(x, y) -> [B] are closures
    on `device` (default cuda); `fm_pair_fn` (x, y, t) -> (v_x, v_y), where
    given, evaluates both flows as one merged network in the MC set and
    the guided samplers (not in SMC). A dispatcher thread drains the request
    queue, merges same-(method, strength) requests arriving within
    `linger_ms` into one batch and slices the results back per request.
    One lock serialises every use of the device (warm-up on request
    threads, batches on the dispatcher)."""

    def __init__(self, fm_x_fn, fm_y_fn, log_ratio_fn, x_shape, y_shape,
                 batch_size=64, num_steps=100, mc_batch_size=256, seed=0,
                 linger_ms: float = 10.0, fm_pair_fn=None,
                 solver: str = "euler",
                 time_grid: str = "uniform", grid_power: float = 2.0,
                 smc_churn: float = 1.0, smc_churn_iters: int = 1,
                 smc_resample_tau: float = 0.5, smc_t_min: float = 0.2,
                 smc_t_max: float = 0.9, smc_group: int = 16, device=None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.x_shape = tuple(x_shape)
        self.y_shape = tuple(y_shape)
        self.num_steps = num_steps
        self.solver = solver
        self.time_grid = time_grid
        self.grid_power = grid_power
        self.smc = {"churn": smc_churn, "churn_iters": smc_churn_iters,
                    "resample_tau": smc_resample_tau,
                    "t_min": smc_t_min, "t_max": smc_t_max,
                    "group": smc_group}
        self._samplers = {}
        self._fm_x, self._fm_y, self._log_ratio = (fm_x_fn, fm_y_fn,
                                                   log_ratio_fn)
        self._fm_pair = fm_pair_fn
        self._mc_set = None
        if log_ratio_fn is not None:
            self._mc_set = generate_mc_set(
                fm_x_fn, fm_y_fn, log_ratio_fn,
                torch.Generator(self.device).manual_seed(seed),
                mc_batch_size, self.x_shape, self.y_shape, num_steps,
                solver=solver, time_grid=time_grid, grid_power=grid_power,
                fm_pair_fn=fm_pair_fn)
        self.mc_batch_size = mc_batch_size
        self.stats = {"dispatches": 0, "requests": 0, "coalesced_max": 1}
        self._linger = max(0.0, linger_ms) / 1000.0
        self._queue: "queue.Queue[_WorkItem]" = queue.Queue()
        self._warm_done = set()
        self._warm_lock = threading.Lock()
        self._device_lock = threading.RLock()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    def _ensure_warm(self, method, strength):
        """First use of a (method, strength): one batch on zeros in the
        requesting thread, before its item enters the queue, so a cold
        method does not stall the dispatcher (on the card the first batch
        also builds the kernels)."""
        key = (method, float(strength))
        if key in self._warm_done:
            return
        with self._warm_lock:
            if key in self._warm_done:
                return
            with self._device_lock:
                s = self._sampler(method, strength)
                noise = tuple(torch.zeros((self.batch_size,) + shp,
                                          device=self.device)
                              for shp in (self.x_shape, self.y_shape))
                out = s(self._generator(0), self.batch_size,
                        self._mc_set if method in MC_METHODS else None,
                        noise)
                out[0].cpu()
            self._warm_done.add(key)

    def _sampler(self, method, strength):
        """sampler(generator, n, mc_set, init_noise) -> (x1, y1, diags) of
        a (method, strength), built once."""
        key = (method, float(strength))
        if key in self._samplers:
            return self._samplers[key]
        if method == "smc":
            if self._log_ratio is None:
                raise ValueError("smc requires a ratio estimator")
            smc = make_smc_sampler(self._fm_x, self._fm_y, SMCSamplerConfig(
                guidance_strength=float(strength), num_steps=self.num_steps,
                x_shape=self.x_shape, y_shape=self.y_shape,
                churn=self.smc["churn"], churn_iters=self.smc["churn_iters"],
                resample_tau=self.smc["resample_tau"],
                resample_t_min=self.smc["t_min"],
                resample_t_max=self.smc["t_max"],
                resample_group=self.smc["group"], solver=self.solver,
                time_grid=self.time_grid, grid_power=self.grid_power),
                self._log_ratio)
            # the churn and resampling draws come from the dispatch's
            # generator; a request's seed fixes its initial noise only, as
            # for every method

            def sampler(gen, n, mc, noise, _s=smc):
                return _s(gen, n, noise)
        else:
            guided = make_guided_sampler_p(
                lambda _, x, t: self._fm_x(x, t),
                lambda _, y, t: self._fm_y(y, t),
                GuidedSamplerConfig(
                    guidance_method=method,
                    guidance_strength=float(strength),
                    num_steps=self.num_steps,
                    mc_batch_size=self.mc_batch_size, x_shape=self.x_shape,
                    y_shape=self.y_shape, solver=self.solver,
                    time_grid=self.time_grid, grid_power=self.grid_power),
                None if self._log_ratio is None
                else (lambda _, x, y: self._log_ratio(x, y)),
                fm_pair_apply=None if self._fm_pair is None
                else (lambda _x, _y: self._fm_pair))

            def sampler(gen, n, mc, noise, _s=guided):
                return _s((None, None, None), gen, n, mc, noise)
        self._samplers[key] = sampler
        return sampler

    def warmup(self, methods=("none",)):
        for m in methods:
            self._ensure_warm(m, 0.5 if m != "none" else 0.0)

    def sample(self, n, method="none", strength=0.0, seed=0):
        """Queue the request for the dispatcher and wait for it; the full n
        is returned (several batches where n exceeds the batch size) as
        numpy arrays (x, y) with the dispatch's seconds."""
        self._ensure_warm(method, strength)
        item = _WorkItem(int(n), method, float(strength), int(seed))
        self._queue.put(item)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def _dispatch_loop(self):
        put_back = None
        while True:
            first = put_back if put_back is not None else self._queue.get()
            put_back = None
            group = [first]
            total = first.n
            deadline = time.perf_counter() + self._linger
            while total < self.batch_size:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if (nxt.method, nxt.strength) != (first.method,
                                                  first.strength):
                    put_back = nxt       # another sampler: the next round
                    break
                group.append(nxt)
                total += nxt.n
            try:
                self._execute(group)
            except Exception as e:  # noqa: BLE001 — reported per request
                for it in group:
                    it.error = e
                    it.event.set()

    def _noise(self, it: _WorkItem):
        """A request's initial (x, y) noise on the device, from its seed."""
        return tuple(torch.randn(
            (it.n,) + shp, generator=self._generator(derive_seed(it.seed, j)),
            dtype=torch.float32, device=self.device)
            for j, shp in enumerate((self.x_shape, self.y_shape)))

    def _execute(self, group):
        method, strength = group[0].method, group[0].strength
        sampler = self._sampler(method, strength)
        mc = self._mc_set if method in MC_METHODS else None
        noise = [self._noise(it) for it in group]
        x0 = torch.cat([nx for nx, _ in noise])
        y0 = torch.cat([ny for _, ny in noise])
        bs = self.batch_size
        pad = (-len(x0)) % bs
        if pad:
            x0 = torch.cat([x0, x0[:1].expand((pad,) + x0.shape[1:])])
            y0 = torch.cat([y0, y0[:1].expand((pad,) + y0.shape[1:])])
        xs, ys = [], []
        t0 = time.perf_counter()
        with self._device_lock:
            for i in range(len(x0) // bs):
                x1, y1, _ = sampler(self._generator(0), bs, mc,
                                    (x0[i * bs:(i + 1) * bs],
                                     y0[i * bs:(i + 1) * bs]))
                # the copy to the host is inside the timed region: what the
                # client waits for
                xs.append(x1.cpu().numpy())
                ys.append(y1.cpu().numpy())
        dt = time.perf_counter() - t0
        x_all = np.concatenate(xs)
        y_all = np.concatenate(ys)
        self.stats["dispatches"] += 1
        self.stats["requests"] += len(group)
        self.stats["coalesced_max"] = max(self.stats["coalesced_max"],
                                          len(group))
        off = 0
        for it in group:
            it.result = (x_all[off:off + it.n], y_all[off:off + it.n], dt)
            it.batched_with = len(group)
            off += it.n
            it.event.set()

    @property
    def compiled(self):
        return sorted(str(k) for k in self._samplers)


def _encode_npz(x, y):
    buf = io.BytesIO()
    np.savez_compressed(buf, x=x, y=y)
    return base64.b64encode(buf.getvalue()).decode()


def _encode_png(x, y):
    from ratio_guided_multimodal_fm_tpu_torch.eval.viz import _pair_grid

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "grid.png")
        _pair_grid(torch.from_numpy(x), torch.from_numpy(y), p,
                   "served pairs", num_cols=8, num_rows=max(1, len(x) // 8))
        with open(p, "rb") as f:
            return base64.b64encode(f.read()).decode()


def make_handler(service: SamplerService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "compiled": service.compiled,
                                 "batch_size": service.batch_size,
                                 "stats": service.stats})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/sample":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                num = int(req.get("num_samples", 16))
                method = req.get("guidance_method", "none")
                strength = float(req.get("guidance_strength", 0.0))
                seed = int(req.get("seed", 0))
                fmt = req.get("format", "npz")
                if method not in METHODS:
                    self._send(400, {"error": f"unknown method {method}"})
                    return
                x, y, dt = service.sample(num, method, strength, seed)
                payload = (_encode_png(x, y) if fmt == "png"
                           else _encode_npz(x, y))
                self._send(200, {
                    "num_samples": len(x),
                    "sample_time_sec": round(dt, 4),
                    "samples_per_sec": round(len(x) / dt, 2),
                    "format": fmt,
                    "data_b64": payload,
                })
            except Exception as e:  # noqa: BLE001 — reported, not fatal
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags (the multi-process flags are refused until they
    are ported; --data_root and --no_prefetch are accepted with nothing to
    read; --merged_unet merges the experiment-1 flows, as in JAX)."""
    parser = argparse.ArgumentParser(description="Serve guided pair sampling")
    parser.add_argument("--experiment", type=str, default="mnist_svhn",
                        choices=["mnist_svhn", "mnist_transform"])
    parser.add_argument("--transform_type", type=str, default="rotate90")
    parser.add_argument("--loss_type", type=str, default="disc")
    parser.add_argument("--port", type=int, default=8800)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_steps", type=int, default=100)
    parser.add_argument("--mc_batch_size", type=int, default=256)
    add_solver_flag(parser)
    add_reflow_flag(parser)
    add_smc_flags(parser)
    add_ema_flag(parser)
    add_common_flags(parser)
    # the experiment-1 loaders read --model; serve has the U-Net only
    parser.set_defaults(model="unet")
    return parser


def build_service(args) -> SamplerService:
    """The service of make_parser()'s `args` on the checkpoints under
    ./checkpoints, loaded as the sample CLIs load them (the SMC defaults
    are the global G 16, tau 0.5 for both experiments, as in JAX)."""
    device = init_runtime(args, training=False)
    smc_kw = dict(smc_churn=args.smc_churn,
                  smc_churn_iters=args.smc_churn_iters,
                  smc_resample_tau=args.smc_resample_tau,
                  smc_t_min=args.smc_t_min, smc_t_max=args.smc_t_max,
                  smc_group=args.smc_group)
    fm_pair = None
    if args.experiment == "mnist_svhn":
        fm_x, fm_y, ratio = load_mnist_svhn_models(
            args.loss_type, True, device, dtype_of(args), args.reflow,
            args.ema, args.ratio_ema)
        shapes = ((32, 32, 1), (32, 32, 3))
    else:
        fm_x, fm_y = load_exp1_flows(args, device)
        ratio = load_exp1_ratio(args, device)
        shapes = ((28, 28, 1), (28, 28, 1))
        fm_pair = maybe_merged_pair_fn(fm_x, fm_y, args)
    return SamplerService(
        velocity_fn(fm_x), velocity_fn(fm_y), ratio_log_fn(ratio), *shapes,
        args.batch_size, args.num_steps, args.mc_batch_size, args.seed,
        fm_pair_fn=fm_pair, solver=args.solver, time_grid=args.time_grid,
        grid_power=args.grid_power, device=device, **smc_kw)


def main(argv=None):
    args = make_parser().parse_args(argv)
    service = build_service(args)
    print("Warming up (building the kernels, one batch per method)...")
    service.warmup(("none", "mc_feng"))
    print(f"Serving on http://127.0.0.1:{args.port}  "
          f"(batch={args.batch_size}, steps={args.num_steps}, "
          f"device={service.device})")
    ThreadingHTTPServer(("127.0.0.1", args.port),
                        make_handler(service)).serve_forever()


if __name__ == "__main__":
    main()
