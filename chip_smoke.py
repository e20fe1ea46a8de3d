"""Drive the PyTorch/CUDA port's eval forward once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero without the final ``ok`` line:

1. Device: the card's name and power limit (``nvidia-smi``) and whether the
   host voxelizer's native library is in use.
2. Kernel vs plain twin: the CUDA gather-GEMM (built from
   ``instancerefer_tpu_torch/csrc/`` at first use) against
   ``ops/sparse.gather_conv`` at three main-path shapes of a 32-scene batch
   (scene stem 7 -> 32 over ``nbr3``, stage-1 down 32 -> 64 over ``down``,
   stage-3 residual 128 -> 128 over ``nbr3``), in f32 and bf16, with and
   without the fused BN/ReLU epilogue.  Times are CUDA-event medians of 10.
3. Slice parity, card vs CPU: eval forward + ``get_loss`` + ``get_eval`` on
   a 2-scene batch at the full-size spec, f32 with TF32 off, BN running
   statistics moved off their defaults.
4. Full size: 32-scene batches (the bench's synthetic scenes) in the bf16
   policy, three batches from distinct seeds, the first repeated; outputs
   finite, ``ref_iou`` in [0, 1], 26 kernel launches per forward; eval
   scenes/s and peak device memory.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.
Weights are random (``torch.Generator`` seeds); scenes are synthetic.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import numpy as np
import torch

# the spec of config/band_profile.synthetic.yaml, as literals (no yaml here);
# pallas_conv only selects the raster row order, the port ignores the bands
SPEC_KW = dict(
    scene_caps=(18176, 4352, 1280, 512, 256),
    inst_caps=(1792, 1792, 1280, 512, 256),
    max_candidates=8,
    max_instances=24,
    pallas_conv=True,
)
SCENE_KW = dict(num_points=40000, num_instances=12, num_candidates=4)
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
BATCH = 32
CONVS_PER_FORWARD = 26  # 2 encoders x (stem + 4 x (down + 2 subm))
# kernel vs twin: |err| <= TOL * max|ref|.  f32 differs only in summation
# order; bf16 outputs round the same f32 sum, so they may differ by one
# bf16 ulp (2^-7 relative) where the two sums straddle a rounding boundary.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# slice parity, card vs CPU (f32, TF32 off): |gpu - cpu| <= ATOL + RTOL*|cpu|;
# sums run in other orders and the BEV scatter uses atomics
SLICE_ATOL, SLICE_RTOL = 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10) -> float:
    fn()  # warm
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_model(spec, seed: int):
    """Random weights from a generator; BN running statistics moved off
    their defaults so the folded epilogue is exercised."""
    from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer

    gen = torch.Generator().manual_seed(seed)
    model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                n = m.running_mean.shape[0]
                m.running_mean += 0.02 * torch.randn(n, generator=gen)
                m.running_var *= 0.5 + torch.rand(n, generator=gen)
    return model.eval()


def run_slice(model, dd, mean_size):
    from instancerefer_tpu_torch.train.evaluate import get_eval
    from instancerefer_tpu_torch.train.losses import get_loss

    with torch.no_grad():
        return get_eval(get_loss(model(dd), mean_size))


def phase_kernel(batch, dev):
    from instancerefer_tpu_torch.ops import sparse
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = (
        ("scene stem", "scene_nbr3_0", "scene_nbr3_0", 7, 32),
        ("scene stage1 down", "scene_down_1", "scene_nbr3_0", 32, 64),
        ("scene stage3 residual", "scene_nbr3_3", "scene_nbr3_3", 128, 128),
    )
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for name, key, in_key, cin, cout in shapes:
        nbr = torch.from_numpy(np.ascontiguousarray(batch[key], np.int32)).to(dev)
        v_in = batch[in_key].shape[0]
        k = nbr.shape[1]
        for dt in (torch.float32, torch.bfloat16):
            feats = torch.randn(v_in, cin, device=dev, generator=gen).to(dt)
            w = (torch.randn(k, cin, cout, device=dev, generator=gen) / (k * cin) ** 0.5).to(dt)
            for epi in (False, True):
                sc = (0.5 + torch.rand(cout, device=dev, generator=gen)) if epi else None
                bi = 0.1 * torch.randn(cout, device=dev, generator=gen) if epi else None
                got = gather_conv(feats, nbr, w, sc, bi, relu=epi)
                ref = sparse.gather_conv(feats, nbr, w, sc, bi, relu=epi)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = KERNEL_TOL[dt] * max(scale, 1e-30)
                t_k = median_ms(lambda: gather_conv(feats, nbr, w, sc, bi, relu=epi))
                t_p = median_ms(lambda: sparse.gather_conv(feats, nbr, w, sc, bi, relu=epi))
                log(f"[kernel] {name} V_out={nbr.shape[0]} K={k} {cin}->{cout} "
                    f"{str(dt)[6:]} epilogue={epi}: max_abs={err:.3e} max_rel={err / max(scale, 1e-30):.3e} "
                    f"(tol {KERNEL_TOL[dt]:g} x max|ref|={scale:.3f}) "
                    f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f}")
                if not err <= tol:
                    raise AssertionError(f"gather_conv disagrees with its twin at {name} {dt} epilogue={epi}")
                worst = max(worst, err)
                if dt == torch.bfloat16 and epi:  # the main path's configuration
                    ms += t_k
                    plain_ms += t_p
    return worst, ms, plain_ms


def phase_parity(spec, dev):
    from instancerefer_tpu_torch.data.host import batch_to_torch, make_batch
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype

    set_compute_dtype(None)
    batch = make_batch(2, spec, seed=3, mean_size_arr=MEAN_SIZE, **SCENE_KW)
    cpu_model = make_model(spec, seed=1)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    cpu = run_slice(cpu_model, batch_to_torch(batch, spec, "cpu"), ms)
    gpu = run_slice(gpu_model, batch_to_torch(batch, spec, dev), ms.to(dev))
    torch.cuda.synchronize()
    cand = cpu["cand_mask"]
    checks = {
        "lang_scores": None, "attribute_scores": cpu["score_mask"],
        "relation_scores": cand, "scene_scores": cand, "seg_scores": None, "loss": None,
    }
    for key, mask in checks.items():
        a, b = gpu[key].cpu(), cpu[key]
        if mask is not None:
            a, b = a[mask], b[mask]
        err = (a - b).abs()
        bound = SLICE_ATOL + SLICE_RTOL * b.abs()
        log(f"[parity] {key}: {b.numel()} valid entries, max_abs={err.max().item():.3e} "
            f"(atol {SLICE_ATOL:g} + rtol {SLICE_RTOL:g})")
        if b.numel() and not bool((err <= bound).all()):
            raise AssertionError(f"card and CPU disagree on {key}")
    n_scored = int(cpu["score_mask"].sum())
    if n_scored == 0:
        raise AssertionError("parity batch has no scored candidates")


def phase_full(spec, dev, batch0, model):
    from instancerefer_tpu_torch.data.host import batch_to_torch, make_batch
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype

    set_compute_dtype("bfloat16")
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    batches = [batch0] + [
        make_batch(BATCH, spec, seed=s, mean_size_arr=MEAN_SIZE, **SCENE_KW) for s in (1, 2)
    ]
    dds = [batch_to_torch(b, spec, dev) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    repeats = 5

    gather_conv.launches = 0
    outs = [run_slice(model, dds[0], ms)]  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        outs.append(run_slice(model, dds[0], ms))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    outs += [run_slice(model, dd, ms) for dd in dds[1:]]
    torch.cuda.synchronize()
    launches = gather_conv.launches
    n_forward = len(outs)

    b, c = BATCH, spec.max_candidates
    shapes = {"lang_scores": (b, spec.num_classes), "attribute_scores": (b, c),
              "relation_scores": (b, c), "scene_scores": (b, c), "seg_scores": (b, 9),
              "loss": (), "ref_iou": (b,)}
    for out in outs:
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"{key}: shape {tuple(out[key].shape)} or non-finite values")
        iou = out["ref_iou"]
        if not bool(((iou >= 0) & (iou <= 1)).all()):
            raise AssertionError("ref_iou outside [0, 1]")
    if launches != CONVS_PER_FORWARD * n_forward:
        raise AssertionError(f"{launches} kernel launches for {n_forward} forwards")
    peak = torch.cuda.max_memory_allocated(dev)
    sps = BATCH * repeats / dt
    for i, out in enumerate(outs[-3:]):
        log(f"[full] batch seed {i}: loss={out['loss'].item():.4f} "
            f"ref_acc_mean={out['ref_acc_mean'].item():.4f} "
            f"mean_ref_iou={out['ref_iou'].mean().item():.4f} num_missed={int(out['num_missed'])}")
    log(f"[full] B={BATCH} bf16: {n_forward} forwards, {launches} kernel launches "
        f"({launches // n_forward} per forward); eval {sps:.2f} scenes/s "
        f"(forward+get_loss+get_eval, mean over {repeats} repeats, {dt / repeats * 1e3:.2f} ms/batch); "
        f"peak device memory {peak / 2**20:.1f} MiB")
    set_compute_dtype(None)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from instancerefer_tpu_torch.data.host import BatchSpec, make_batch, voxelize
    from instancerefer_tpu_torch.ops import gather_conv as gc_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] host voxelizer native: {voxelize.native_available()}")
    t0 = time.perf_counter()
    gc_mod.build()
    log(f"[build] gather_conv ready in {time.perf_counter() - t0:.1f} s")

    spec = BatchSpec(**SPEC_KW)
    t0 = time.perf_counter()
    batch0 = make_batch(BATCH, spec, seed=0, mean_size_arr=MEAN_SIZE, **SCENE_KW)
    log(f"[host] {BATCH}-scene batch built in {time.perf_counter() - t0:.1f} s")

    worst, ms, plain_ms = phase_kernel(batch0, dev)
    phase_parity(spec, dev)
    model = make_model(spec, seed=2).to(dev)
    launches = phase_full(spec, dev, batch0, model)

    # ms / plain_ms: the sum over phase 2's three shapes, bf16 with epilogue
    log(json.dumps({"kernels": [{
        "name": "gather_conv",
        "route": "cuda",
        "source": "instancerefer_tpu_torch/csrc/gather_conv.cu",
        "replaces": "instancerefer_tpu/ops/pallas_conv.py:51",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
