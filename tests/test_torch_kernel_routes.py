"""Which path a sparse-conv call takes, and the tensor-core kernels against
their plain twins on the card.

``ops/gather_conv.route`` decides from the device, the input type and Cin
alone: the plain twin on the CPU; on a card the tensor-core kernels for bf16
with Cin >= 16 (K1's down, residual and ``up8`` calls, and K2) and the FMA
kernels otherwise (f32, and the 7-channel stems).  K3 has an FMA kernel
only.

The card tests (``@pytest.mark.gpu``) skip without a CUDA device.  This file
imports no JAX, so on a card it also runs without the repo's conftest:
``python -m pytest tests/test_torch_kernel_routes.py -m gpu --noconftest``.
Tolerances as in ``chip_smoke.py``: bf16 outputs within 1e-2 of the largest
value (one bf16 ulp where two f32 sums round apart); f32 outputs (K1's f32
output, K2's dX) within 1e-5 and dW within 1e-4 of the largest value.
"""

import itertools

import pytest
import torch

from instancerefer_tpu_torch.ops import conv_bwd, sparse
from instancerefer_tpu_torch.ops import gather_conv as G

WIDTHS = (32, 64, 128)


@pytest.mark.parametrize("dtype, cin, device, want", [
    (torch.bfloat16, 64, "cpu", "twin"),
    (torch.float32, 64, "cpu", "twin"),
    (torch.bfloat16, 7, "cpu", "twin"),
    (torch.bfloat16, 32, "cuda", "tensor_core"),
    (torch.bfloat16, 128, "cuda", "tensor_core"),
    (torch.bfloat16, 16, "cuda", "tensor_core"),
    (torch.bfloat16, 15, "cuda", "fma"),
    (torch.bfloat16, 7, "cuda", "fma"),
    (torch.float32, 128, "cuda", "fma"),
    (torch.float32, 7, "cuda", "fma"),
])
def test_route_from_device_dtype_and_cin(dtype, cin, device, want):
    assert G.route(dtype, cin, device) == want
    assert G.route(dtype, cin, torch.device(device)) == want


def test_tensor_core_path_checks_widths_and_alignment():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    G.check_tc("k", (64, 128), x)
    for widths in ((48, 64), (64, 16), (256, 64)):
        with pytest.raises(ValueError, match="widths"):
            G.check_tc("k", widths, x)
    with pytest.raises(ValueError, match="aligned"):
        G.check_tc("k", (64, 64), x.view(-1)[1:65].view(1, 64))


@pytest.mark.parametrize("cin", [7, 32, 64])
def test_cpu_calls_take_the_twin_and_launch_nothing(cin):
    """bf16 on the CPU: the twin, for every Cin, no kernel launched."""
    nbr = torch.randint(-1, 10, (12, 27), dtype=torch.int32)
    x = torch.randn(10, cin).bfloat16()
    w = torch.randn(27, cin, 32).bfloat16()
    before = (G.gather_conv.launches, conv_bwd.subm_conv_bwd.launches)
    assert torch.equal(G.gather_conv(x, nbr, w), sparse.gather_conv(x, nbr, w))
    if cin in WIDTHS:
        g = torch.randn(10, 32).bfloat16()
        nbr = torch.randint(-1, 10, (10, 27), dtype=torch.int32)
        got, want = conv_bwd.subm_conv_bwd(x, nbr, g, w), sparse.subm_conv_bwd(x, nbr, g, w)
        assert all(a.dtype == torch.float32 and torch.equal(a, b) for a, b in zip(got, want))
    assert (G.gather_conv.launches, conv_bwd.subm_conv_bwd.launches) == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _map(gen, v_out, v_in, k, dev):
    """Random indices, 40% valid, with two whole 64-row tiles and parts of
    two more all padding, one offset empty in one tile and one offset empty
    everywhere."""
    nbr = torch.randint(0, v_in, (v_out, k), generator=gen, device=dev, dtype=torch.int32)
    nbr[torch.rand(v_out, k, generator=gen, device=dev) >= 0.4] = -1
    nbr[64:200] = -1
    nbr[300:400, 3] = -1
    nbr[:, 5] = -1
    return nbr.contiguous()


def _close(got, ref, tol):
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", list(itertools.product(WIDTHS, WIDTHS)))
def test_tensor_core_k1_matches_twin_on_card(cin, cout):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin + cout)
    nbr = _map(gen, 1000, 900, 27, dev)
    x = torch.randn(900, cin, device=dev, generator=gen).bfloat16()
    w = (torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5).bfloat16()
    sc = 0.5 + torch.rand(cout, device=dev, generator=gen)
    bi = 0.1 * torch.randn(cout, device=dev, generator=gen)
    assert G.route(x.dtype, cin, x.device) == "tensor_core"
    before = G.gather_conv.launches
    got = G.gather_conv(x, nbr, w, sc, bi, relu=True)
    assert G.gather_conv.launches == before + 1
    _close(got, sparse.gather_conv(x, nbr, w, sc, bi, relu=True), 1e-2)
    assert torch.equal(got[64:192].float(), torch.relu(bi).bfloat16().float().expand(128, cout))
    # the down conv's dX over up8: one valid neighbour a row, f32 output
    up8 = torch.full((1000, 8), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(1000, device=dev)
    up8[rows, rows % 8] = torch.randint(0, 900, (1000,), generator=gen, device=dev,
                                        dtype=torch.int32)
    w8 = w[:8].contiguous()
    got = G.gather_conv(x, up8, w8, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, sparse.gather_conv(x, up8, w8, out_dtype=torch.float32), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", list(itertools.product(WIDTHS, WIDTHS)))
def test_tensor_core_k2_matches_twin_on_card(cin, cout):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * cout)
    nbr = _map(gen, 1000, 1000, 27, dev)
    x = torch.randn(1000, cin, device=dev, generator=gen).bfloat16()
    g = torch.randn(1000, cout, device=dev, generator=gen).bfloat16()
    w = (torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5).bfloat16()
    dx, dw = conv_bwd.subm_conv_bwd(x, nbr, g, w)
    ref_dx, ref_dw = sparse.subm_conv_bwd(x, nbr, g, w)
    _close(dx, ref_dx, 1e-5)
    _close(dw, ref_dw, 1e-4)
    assert torch.equal(dx[64:200], torch.zeros_like(dx[64:200]))
    assert torch.equal(dw, conv_bwd.subm_conv_bwd(x, nbr, g, w)[1])  # bit-identical


@pytest.mark.gpu
def test_tensor_core_path_refuses_what_it_cannot_take():
    dev = _card()
    nbr = torch.zeros(4, 27, dtype=torch.int32, device=dev)
    x = torch.zeros(4, 48, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="widths"):
        G.gather_conv(x, nbr, torch.zeros(27, 48, 32, dtype=torch.bfloat16, device=dev))
