"""The PyTorch port's serving layer (cli/serve.py): the counterparts of
tests/test_serve.py on toy velocity and ratio functions on the CPU, the
service's mc_feng output held bit for bit to the port's own sampler on the
same noise, and the serve CLI on exported checkpoints."""
import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from ratio_guided_multimodal_fm_tpu_torch.cli import serve
from ratio_guided_multimodal_fm_tpu_torch.cli.serve import (
    SamplerService,
    make_handler,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import derive_seed
from ratio_guided_multimodal_fm_tpu_torch.flow.cfm import make_time_grid
from ratio_guided_multimodal_fm_tpu_torch.sample.guided import (
    GuidedSamplerConfig,
    generate_mc_set,
    make_guided_sampler_p,
)

torch.set_num_threads(2)
SHAPE = (6, 6, 1)


def _fm(x, t):
    return -0.1 * x


def _log_ratio(x, y):
    return -((x.reshape(x.shape[0], -1) - y.reshape(y.shape[0], -1))
             ** 2).mean(1)


def _service(**kw):
    return SamplerService(_fm, _fm, _log_ratio, SHAPE, SHAPE, batch_size=8,
                          num_steps=4, mc_batch_size=8, device="cpu", **kw)


def test_service_sample_and_padding():
    svc = _service()
    x, y, dt = svc.sample(3, "mc_feng", 0.5, seed=1)
    assert isinstance(x, np.ndarray) and x.shape == (3,) + SHAPE
    assert np.isfinite(x).all() and np.isfinite(y).all() and dt > 0
    # SMC serves through the same coalescing path (no MC set)
    x, y, _ = svc.sample(5, "smc", 1.0, seed=2)
    assert x.shape == (5,) + SHAPE and np.isfinite(x).all()
    # an over-batch request is fulfilled in several batches
    x, _, _ = svc.sample(20, "none", 0.0)
    assert x.shape[0] == 20
    # the batches carry distinct noise: no duplicated blocks
    assert not np.allclose(x[:8], x[8:16])


def test_http_roundtrip():
    svc = _service()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["batch_size"] == 8

        req = urllib.request.Request(
            f"{url}/sample", method="POST",
            data=json.dumps({"num_samples": 4, "guidance_method": "mc_feng",
                             "guidance_strength": 0.7}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["num_samples"] == 4 and out["format"] == "npz"
        z = np.load(io.BytesIO(base64.b64decode(out["data_b64"])))
        assert z["x"].shape == (4,) + SHAPE and z["y"].shape == (4,) + SHAPE

        # an unknown method: 400 with the reason
        req = urllib.request.Request(
            f"{url}/sample", method="POST",
            data=json.dumps({"guidance_method": "bogus"}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
        assert "bogus" in json.loads(e.value.read())["error"]

        # unknown paths: 404 on GET and POST
        for method in ("GET", "POST"):
            req = urllib.request.Request(f"{url}/nope", method=method,
                                         data=b"{}" if method == "POST"
                                         else None)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_failed_dispatch_is_a_500():
    """A dispatch that raises reports the error to its request (500), and
    the service keeps serving."""
    broken = {"on": False}

    def log_ratio(x, y):
        if broken["on"]:
            raise FloatingPointError("ratio net exploded")
        return _log_ratio(x, y)

    svc = SamplerService(_fm, _fm, log_ratio, SHAPE, SHAPE, batch_size=8,
                         num_steps=4, mc_batch_size=8, device="cpu")
    svc.sample(2, "smc", 1.0)            # warm: the dispatcher runs it next
    broken["on"] = True
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/sample",
            method="POST", data=json.dumps({
                "guidance_method": "smc", "guidance_strength": 1.0,
                "num_samples": 2}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 500
        assert "ratio net exploded" in json.loads(e.value.read())["error"]
        broken["on"] = False
        x, _, _ = svc.sample(2, "smc", 1.0, seed=3)
        assert x.shape == (2,) + SHAPE
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)


def test_concurrent_requests_coalesce():
    """Same-(method, strength) requests issued together share dispatches,
    each getting its seed's samples."""
    svc = _service(linger_ms=200.0)
    svc.sample(1, "mc_feng", 0.5, seed=0)    # warm before racing
    base = dict(svc.stats)
    results = {}

    def worker(i):
        results[i] = svc.sample(2, "mc_feng", 0.5, seed=100 + i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert len(results) == 4
    for x, _, _ in results.values():
        assert x.shape == (2,) + SHAPE and np.isfinite(x).all()
    # 4 × 2 samples fit one batch of 8: fewer dispatches than requests
    d = svc.stats["dispatches"] - base["dispatches"]
    r = svc.stats["requests"] - base["requests"]
    assert r == 4 and d < r and svc.stats["coalesced_max"] >= 2
    # the same seed again, alone: the same samples
    x_again, _, _ = svc.sample(2, "mc_feng", 0.5, seed=100)
    np.testing.assert_array_equal(x_again, results[0][0])


def test_solver_and_time_grid_reach_serving():
    """On v(x) = -c·x the served endpoints follow each solver's per-step
    factor (the same seed gives the same initial noise)."""
    c = 0.1

    def svc(**kw):
        return SamplerService(_fm, _fm, lambda x, y: torch.zeros(x.shape[0]),
                              SHAPE, SHAPE, batch_size=8, num_steps=4,
                              mc_batch_size=8, device="cpu", **kw)

    x_eu, _, _ = svc().sample(8, "none", 0.0, seed=5)
    x_mid, _, _ = svc(solver="midpoint").sample(8, "none", 0.0, seed=5)
    dt = 0.25
    f_eu = (1 - c * dt) ** 4
    f_mid = (1 - c * dt + (c * dt) ** 2 / 2) ** 4
    np.testing.assert_allclose(x_mid, x_eu * (f_mid / f_eu), rtol=1e-5)
    _, dts = make_time_grid(4, "early", power=2.0)
    f_early = float(np.prod(1.0 - c * dts.astype(np.float64)))
    x_ear, _, _ = svc(time_grid="early").sample(8, "none", 0.0, seed=5)
    np.testing.assert_allclose(x_ear, x_eu * (f_early / f_eu), rtol=1e-5)


def test_service_mc_feng_equals_the_sampler_bit_for_bit():
    """A padded request (3 of a batch of 8) through the service equals the
    port's guided sampler on the same noise and MC set, bit for bit."""
    svc = _service(seed=11)
    x, y, _ = svc.sample(3, "mc_feng", 0.5, seed=7)
    noise = [torch.randn((3,) + SHAPE, generator=torch.Generator()
                         .manual_seed(derive_seed(7, j))) for j in (0, 1)]
    noise = [torch.cat([a, a[:1].expand((5,) + SHAPE)]) for a in noise]
    mc = generate_mc_set(_fm, _fm, _log_ratio,
                         torch.Generator().manual_seed(11), 8, SHAPE, SHAPE,
                         4)
    sampler = make_guided_sampler_p(
        lambda _, a, t: _fm(a, t), lambda _, a, t: _fm(a, t),
        GuidedSamplerConfig(guidance_method="mc_feng", guidance_strength=0.5,
                            num_steps=4, mc_batch_size=8, x_shape=SHAPE,
                            y_shape=SHAPE),
        lambda _, a, b: _log_ratio(a, b))
    wx, wy, _ = sampler((None, None, None), torch.Generator().manual_seed(0),
                        8, mc, tuple(noise))
    np.testing.assert_array_equal(x, wx[:3].numpy())
    np.testing.assert_array_equal(y, wy[:3].numpy())


def test_serve_cli_refusals_and_service_on_checkpoints(tmp_path,
                                                      monkeypatch):
    """build_service on experiment-2 reference-layout .pth files
    (full-width random-init nets; 1 step, a batch of 2) with the global SMC
    defaults (G 16, tau 0.5, as in JAX); --merged_unet accepted, and a
    no-op there (the experiment-2 nets cannot merge); --num_processes
    alone is one process (no coordinator), which goes on to load; a
    missing checkpoint an error."""
    from ratio_guided_multimodal_fm_tpu_torch import models as pm

    monkeypatch.chdir(tmp_path)
    parser = serve.make_parser()
    with pytest.raises(SystemExit, match="checkpoint not found"):
        serve.build_service(parser.parse_args(["--device", "cpu"]))
    with pytest.raises(SystemExit, match="checkpoint not found"):
        serve.build_service(parser.parse_args(["--device", "cpu",
                                               "--num_processes", "2"]))
    (tmp_path / "checkpoints").mkdir()
    torch.manual_seed(0)
    for net, fname in ((pm.FlowMatchingUNetMNIST(img_size=32),
                        "flow_mnist32_best.pth"),
                       (pm.FlowMatchingUNetSVHN(), "flow_svhn_best.pth"),
                       (pm.RatioEstimatorMNISTSVHN(),
                        "ratio_disc_mnist_svhn_best.pth")):
        torch.save(net.state_dict(), tmp_path / "checkpoints" / fname)
    svc = serve.build_service(parser.parse_args([
        "--device", "cpu", "--batch_size", "2", "--num_steps", "1",
        "--mc_batch_size", "2", "--merged_unet"]))
    assert svc._fm_pair is None
    assert svc.smc["group"] == 16 and svc.smc["resample_tau"] == 0.5
    x, y, _ = svc.sample(3, "smc", 1.0, seed=4)
    assert x.shape == (3, 32, 32, 1) and y.shape == (3, 32, 32, 3)
    assert np.isfinite(x).all() and np.isfinite(y).all()
