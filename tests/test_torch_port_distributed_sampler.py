"""The port's guided sampler over a ('data', 'mc') mesh of gloo workers on
the CPU, the counterparts of the JAX package's
tests/test_distributed_sampler.py and test_multihost_sampler.py.

Meshes (2, 1) and (1, 2) with two workers, (2, 2) with four. Each worker
loads the same small nets (the state dicts written by the parent) and
runs the distributed sampler with mc_feng guidance:

* on a generator seeded like the parent's: equal to the port's
  single-process sampler (1e-5, float32, the reductions in another
  order);
* on injected initial noise and MC set: equal to the JAX package's
  single-device sampler on the same inputs (the cross-framework bound of
  tests/test_torch_port_sampler.py, 1e-4) and to the port's
  single-process one (1e-5);
* `mc_feng_guidance` with its MC set split over the mc group: g and every
  diagnostic (the global extrema, the argmax with ties toward the largest
  global index) equal the JAX function's on the whole set.

`mc_refresh > 1` is refused, as in JAX.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_workers import run_workers
from ratio_guided_multimodal_fm_tpu.sample import guided as jg
from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    ratio_log_fn,
    velocity_fn,
)
from ratio_guided_multimodal_fm_tpu_torch.parallel import (
    make_distributed_guided_sampler,
    make_distributed_guided_sampler_p,
)
from ratio_guided_multimodal_fm_tpu_torch.sample import guided as pg
from test_torch_port_sampler import (
    UNET_KW,
    X_SHAPE,
    Y_SHAPE,
    _pair_of_unets,
    _ratio_pair,
)

torch.set_num_threads(2)

B, N_MC, STEPS, GAMMA = 8, 8, 4, 1.0

CFG = dict(guidance_method="mc_feng", guidance_strength=GAMMA,
           num_steps=STEPS, mc_batch_size=N_MC, x_shape=X_SHAPE,
           y_shape=Y_SHAPE)

WORKER = """
from ratio_guided_multimodal_fm_tpu_torch.cli.common import (
    ratio_log_fn, velocity_fn)
from ratio_guided_multimodal_fm_tpu_torch.models import (
    FlexibleUNet, RatioEstimatorMNISTSVHN)
from ratio_guided_multimodal_fm_tpu_torch.parallel import (
    make_distributed_guided_sampler, make_mesh)
from ratio_guided_multimodal_fm_tpu_torch.parallel.mesh import (
    axis_group, axis_index)
from ratio_guided_multimodal_fm_tpu_torch.sample import guided as pg

sizes = tuple(int(a) for a in os.environ["MESH"].split(","))
mesh = make_mesh(axis_names=("data", "mc"), axis_sizes=sizes)
kw = {UNET_KW!r}
mx = FlexibleUNet(in_channels=1, **kw).eval()
my = FlexibleUNet(in_channels=3, **kw).eval()
mr = RatioEstimatorMNISTSVHN().eval()
for m, name in ((mx, "mx"), (my, "my"), (mr, "mr")):
    m.load_state_dict(torch.load(os.path.join(OUT, name + ".pt")))
cfg = pg.GuidedSamplerConfig(**{CFG!r})
sampler = make_distributed_guided_sampler(
    velocity_fn(mx), velocity_fn(my), cfg, ratio_log_fn(mr), mesh)
inj = np.load(os.path.join(OUT, "inputs.npz"))
res = {{}}
with torch.no_grad():
    x1, y1 = sampler(torch.Generator().manual_seed(3), {B})
    res["gen_x"], res["gen_y"] = x1.numpy(), y1.numpy()
    x1, y1, diags = sampler(
        torch.Generator().manual_seed(0), {B},
        mc_set=tuple(torch.from_numpy(inj[k]) for k in ("mx", "my", "mr")),
        init_noise=(torch.from_numpy(inj["x0"]), torch.from_numpy(inj["y0"])),
        return_diagnostics=True)
    res["inj_x"], res["inj_y"] = x1.numpy(), y1.numpy()
    res["inj_ess"] = diags["ess"].numpy()
    # the guidance alone on this rank's MC shard
    mi, n = axis_index(mesh, "mc"), {N_MC} // sizes[1]
    s = slice(mi * n, (mi + 1) * n)
    g_x, g_y, d = pg.mc_feng_guidance(
        torch.from_numpy(inj["gx"]), torch.from_numpy(inj["gy"]),
        torch.from_numpy(inj["tx"][s]), torch.from_numpy(inj["ty"][s]),
        torch.from_numpy(inj["tr"][s]), 0.6, axis_group(mesh, "mc"))
    res["g_x"], res["g_y"] = g_x.numpy(), g_y.numpy()
    for k, v in d.items():
        res["d_" + k] = v.numpy()
np.savez(os.path.join(OUT, f"out_{{RANK}}.npz"), **res)
"""


def _np(*shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("dsamp")
    jx, px, mx = _pair_of_unets(1, 0)
    jy, py, my = _pair_of_unets(3, 1)
    jr, pr, mr = _ratio_pair()
    for m, name in ((mx, "mx"), (my, "my"), (mr, "mr")):
        torch.save(m.state_dict(), out / f"{name}.pt")
    tx, ty = _np(N_MC, *X_SHAPE, seed=7), _np(N_MC, *Y_SHAPE, seed=8)
    tr = np.exp(_np(N_MC, seed=9, scale=2.0))
    # a tie for the argmax across the two halves of the MC set
    tx[N_MC // 2 + 1], ty[N_MC // 2 + 1] = tx[1], ty[1]
    tr[N_MC // 2 + 1] = tr[1]
    inputs = dict(
        x0=_np(B, *X_SHAPE, seed=1), y0=_np(B, *Y_SHAPE, seed=2),
        mx=_np(N_MC, *X_SHAPE, seed=3), my=_np(N_MC, *Y_SHAPE, seed=4),
        mr=np.exp(_np(N_MC, seed=5, scale=0.5)),
        gx=tx[[1, 0, 2, 3]] * 0.6 + 0.1 * _np(4, *X_SHAPE, seed=10),
        gy=ty[[1, 0, 2, 3]] * 0.6 + 0.1 * _np(4, *Y_SHAPE, seed=11),
        tx=tx, ty=ty, tr=tr)
    inputs["gx"][0], inputs["gy"][0] = 0.6 * tx[1], 0.6 * ty[1]
    np.savez(out / "inputs.npz", **inputs)
    body = WORKER.format(UNET_KW=UNET_KW, CFG=CFG, B=B, N_MC=N_MC)
    runs = {}
    for mesh, n in (("2,1", 2), ("1,2", 2), ("2,2", 4)):
        d = out / mesh.replace(",", "x")
        d.mkdir()
        for f in ("mx.pt", "my.pt", "mr.pt", "inputs.npz"):
            os.link(out / f, d / f)
        run_workers(body, n, d, env_extra={"MESH": mesh})
        runs[mesh] = [dict(np.load(d / f"out_{r}.npz")) for r in range(n)]
    cfg = pg.GuidedSamplerConfig(**CFG)
    single = pg.make_guided_sampler_p(
        lambda m, x, t: velocity_fn(m)(x, t),
        lambda m, y, t: velocity_fn(m)(y, t), cfg,
        lambda m, x, y: ratio_log_fn(m)(x, y))
    with torch.no_grad():
        ref_gen = single((mx, my, mr), torch.Generator().manual_seed(3), B)
        ref_inj = single(
            (mx, my, mr), torch.Generator().manual_seed(0), B,
            mc_set=tuple(torch.from_numpy(inputs[k])
                         for k in ("mx", "my", "mr")),
            init_noise=(torch.from_numpy(inputs["x0"]),
                        torch.from_numpy(inputs["y0"])))
    jsampler = jg.make_guided_sampler_p(
        lambda p, x, t: jx(x, t), lambda p, y, t: jy(y, t),
        jg.GuidedSamplerConfig(**CFG), lambda p, x, y: jr(x, y))
    jx1, jy1, _ = jsampler(
        (None, None, None), jax.random.PRNGKey(0), B,
        mc_set=tuple(jnp.asarray(inputs[k]) for k in ("mx", "my", "mr")),
        init_noise=(jnp.asarray(inputs["x0"]), jnp.asarray(inputs["y0"])))
    jgx, jgy, jd = jg.mc_feng_guidance(
        jnp.asarray(inputs["gx"]), jnp.asarray(inputs["gy"]),
        jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(tr), jnp.float32(0.6))
    return dict(runs=runs, ref_gen=ref_gen, ref_inj=ref_inj,
                jax=(np.asarray(jx1), np.asarray(jy1)),
                jguide=(np.asarray(jgx), np.asarray(jgy),
                        {k: np.asarray(v) for k, v in jd.items()}))


MESHES = ["2,1", "1,2", "2,2"]


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_sampler_equals_single_process_on_a_generator(setup, mesh):
    rx, ry = (a.numpy() for a in setup["ref_gen"][:2])
    assert np.abs(rx).max() > 0.1
    for res in setup["runs"][mesh]:          # assembled on every rank
        np.testing.assert_allclose(res["gen_x"], rx, rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["gen_y"], ry, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_sampler_equals_single_process_and_jax_injected(setup,
                                                                mesh):
    rx, ry, rd = setup["ref_inj"]
    jx1, jy1 = setup["jax"]
    rows = B // int(mesh.split(",")[0])
    for r, res in enumerate(setup["runs"][mesh]):
        np.testing.assert_allclose(res["inj_x"], rx.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(res["inj_y"], ry.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(res["inj_x"], jx1, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(res["inj_y"], jy1, rtol=1e-4, atol=1e-4)
        # this rank's rows' ESS (data coordinate = rank // mc size)
        di = r // int(mesh.split(",")[1])
        np.testing.assert_allclose(
            res["inj_ess"], rd["ess"].numpy()[:, di * rows:(di + 1) * rows],
            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_guidance_reductions_equal_jax(setup, mesh):
    jgx, jgy, jd = setup["jguide"]
    # row 0 ties candidates 1 and 1 + N/2: the whole set's argmax takes the
    # first, a split set the largest global index (JAX's rule for its
    # sharded axis)
    want = jd["w_argmax"].copy()
    assert want[0] == 1
    if mesh.endswith(",2"):
        want[0] = 1 + N_MC // 2
    for res in setup["runs"][mesh]:
        np.testing.assert_allclose(res["g_x"], jgx, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["g_y"], jgy, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(res["d_w_argmax"], want)
        for k in ("ess", "w_min", "w_max", "Z_bar_mean"):
            np.testing.assert_allclose(res["d_" + k], jd[k], rtol=1e-4,
                                       atol=1e-12, err_msg=k)


def test_mc_refresh_refused_with_sharded_mc_axis():
    cfg = pg.GuidedSamplerConfig(**dict(CFG, mc_refresh=2))
    with pytest.raises(ValueError, match="mc_refresh > 1"):
        make_distributed_guided_sampler_p(
            lambda m, x, t: x, lambda m, y, t: y, cfg,
            lambda m, x, y: x.sum((1, 2, 3)), None)
    # the closure form on the one-process mesh is the plain sampler
    sampler = make_distributed_guided_sampler(
        lambda x, t: -x, lambda y, t: -y,
        pg.GuidedSamplerConfig(num_steps=2, x_shape=(2, 2, 1),
                               y_shape=(2, 2, 1)), None, None)
    x1, y1 = sampler(torch.Generator().manual_seed(1), 4)
    assert x1.shape == (4, 2, 2, 1) and torch.isfinite(y1).all()
