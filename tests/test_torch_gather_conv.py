"""The port's sparse-conv gather-GEMM (instancerefer_tpu_torch/ops/gather_conv)
against the JAX package: its plain twin, which the wrapper runs for CPU
tensors, vs ``ops/sparse.gather_conv`` and vs the banded Pallas kernel
``windowed_gather_conv`` in interpret mode, on drop-free banded maps.

Tolerance: f32 on both sides, sums in another order — rtol = atol = 1e-5.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.ops import voxelize as V
from instancerefer_tpu.ops.pallas_conv import windowed_gather_conv
from instancerefer_tpu.ops.sparse import gather_conv as jax_gather_conv

from instancerefer_tpu_torch.ops import gather_conv as G
from instancerefer_tpu_torch.ops import sparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
CAP0, CAP1 = 2048, 512


def _maps(seed, n_samples=2):
    """Stage-1 ``nbr3`` (K = 27, into stage 1) and ``down`` (K = 8, into
    stage 0) of raster-ordered scenes, flattened as collate does."""
    rng = np.random.default_rng(seed)
    nbr3, down = [], []
    for b in range(n_samples):
        pts = rng.uniform(0, 2.5, size=(2500, 3))
        coords, _ = V.quantize(pts, pts.astype(np.float32), 0.05, raster_order=True)
        pyr = V.build_pyramid(coords, owner=0, num_stages=2, caps=[CAP0, CAP1], raster=True)
        st = V.pad_stage(pyr[1], CAP1, CAP0)
        nbr3.append(np.where(st.nbr3 >= 0, st.nbr3 + b * CAP1, -1))
        down.append(np.where(st.down >= 0, st.down + b * CAP0, -1))
    return {
        "subm": (np.concatenate(nbr3).astype(np.int32), n_samples * CAP1),
        "down": (np.concatenate(down).astype(np.int32), n_samples * CAP0),
    }


@pytest.fixture(scope="module")
def maps():
    return _maps(0)


def _inputs(rng, v_in, k, cin, cout, epilogue):
    feats = rng.normal(size=(v_in, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, size=cout).astype(np.float32) if epilogue else None
    bi = (0.1 * rng.normal(size=cout)).astype(np.float32) if epilogue else None
    return feats, w, sc, bi


def _port(feats, nbr, w, sc, bi, relu):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return G.gather_conv(t(feats), t(nbr), t(w), t(sc), t(bi), relu=relu).numpy()


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("cin,cout", [(7, 32), (64, 64)])
@pytest.mark.parametrize("kind", ["subm", "down"])
def test_twin_matches_jax_and_pallas(maps, kind, cin, cout, epilogue):
    nbr, v_in = maps[kind]
    k = nbr.shape[1]
    rng = np.random.default_rng(1)
    feats, w, sc, bi = _inputs(rng, v_in, k, cin, cout, epilogue)
    before = G.gather_conv.launches
    got = _port(feats, nbr, w, sc, bi, relu=epilogue)
    assert G.gather_conv.launches == before  # a CPU call launches nothing

    ref = np.asarray(jax_gather_conv(jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w)))
    if epilogue:
        ref = np.maximum(ref * sc + bi, 0.0)
    np.testing.assert_allclose(got, ref, **TOL)

    chunk, window, subwin = 128, 512, 384
    ws, wskt, dropped, total = V.compute_offset_window_starts(
        nbr, chunk, window, subwin, v_in, count_drops=True
    )
    assert dropped == 0 and total == int((nbr >= 0).sum())
    extra = dict(affine_scale=jnp.asarray(sc), affine_bias=jnp.asarray(bi),
                 relu=True) if epilogue else {}
    pallas = np.asarray(windowed_gather_conv(
        jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(ws),
        jnp.asarray(wskt), window=window, chunk=chunk, subwin=subwin,
        center_k=k // 2 if kind == "subm" else None, interpret=True, **extra,
    ))
    # an exact gather equals the banded kernel wherever its bands drop
    # nothing; rows of all-padding chunks (ws == -1) are 0 in the banded
    # kernel and relu(bias) here, so compare live rows only
    live = np.repeat(ws >= 0, chunk)[: len(nbr)]
    np.testing.assert_allclose(got[live], pallas[live], **TOL)


def test_empty_neighbours_give_zero_rows():
    nbr = np.full((5, 27), -1, np.int32)
    nbr[0, 13] = 2
    feats = np.arange(12, dtype=np.float32).reshape(3, 4)
    w = np.ones((27, 4, 32), np.float32)
    out = _port(feats, nbr, w, None, None, relu=False)
    np.testing.assert_array_equal(out[0], np.full(32, feats[2].sum()))
    np.testing.assert_array_equal(out[1:], 0.0)


def test_bf16_twin_rounds_an_f32_sum(maps):
    """bf16 inputs: the twin sums f32 products and rounds once to bf16."""
    nbr, v_in = maps["subm"]
    rng = np.random.default_rng(2)
    feats, w, _, _ = _inputs(rng, v_in, 27, 64, 64, False)
    f16, w16 = torch.from_numpy(feats).bfloat16(), torch.from_numpy(w).bfloat16()
    out = G.gather_conv(f16, torch.from_numpy(nbr), w16)
    assert out.dtype == torch.bfloat16
    ref = sparse.gather_conv(f16.float(), torch.from_numpy(nbr), w16.float())
    assert torch.equal(out, ref.bfloat16())


@pytest.mark.parametrize("bad", ["cout", "dtype", "nbr_dtype", "shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    feats = torch.zeros(10, 8)
    nbr = torch.zeros(4, 27, dtype=torch.int32)
    w = torch.zeros(27, 8, 32)
    if bad == "cout":
        w = torch.zeros(27, 8, 40)
    elif bad == "dtype":
        w = w.double()
    elif bad == "nbr_dtype":
        nbr = nbr.long()
    elif bad == "shape":
        w = torch.zeros(8, 8, 32)
    else:  # neither CPU nor CUDA: no plain fallback
        feats, nbr, w = feats.to("meta"), nbr.to("meta"), w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        G.gather_conv(feats, nbr, w)


def test_imports_and_runs_without_triton_or_nvcc():
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from instancerefer_tpu_torch.ops import gather_conv as G\n"
        "out = G.gather_conv(torch.ones(3, 7), torch.zeros(2, 27, dtype=torch.int32),"
        " torch.ones(27, 7, 32))\n"
        "assert out.shape == (2, 32) and G.gather_conv.launches == 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="", PYTHONPATH=ROOT, CUDA_HOME=os.devnull)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.gpu
def test_kernel_matches_twin_on_card(maps):
    """Runs on a GPU only (the kernel has no CPU mode); skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    nbr, v_in = maps["subm"]
    rng = np.random.default_rng(3)
    feats, w, sc, bi = _inputs(rng, v_in, 27, 64, 64, True)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (feats, nbr, w, sc, bi)]
    before = G.gather_conv.launches
    got = G.gather_conv(*args, relu=True)
    torch.cuda.synchronize()
    assert G.gather_conv.launches == before + 1
    ref = sparse.gather_conv(*args, relu=True)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)
