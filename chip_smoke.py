"""Drive the PyTorch/CUDA port's eval forward and train step on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero without the final ``ok`` line:

1. Device: the card's name and power limit (``nvidia-smi``) and whether the
   host voxelizer's native library is in use; the build of every CUDA
   source under ``instancerefer_tpu_torch/csrc/`` (one ``nvcc`` each, all at
   once).
2. K1 vs plain twin: the CUDA gather-GEMM against ``ops/sparse.gather_conv``
   at three main-path shapes of a 32-scene batch (scene stem 7 -> 32 over
   ``nbr3``, stage-1 down 32 -> 64 over ``down``, stage-3 residual
   128 -> 128 over ``nbr3``), in f32 and bf16, with and without the fused
   BN/ReLU epilogue.  Times are CUDA-event medians of 10.
3. Slice parity, card vs CPU: eval forward + ``get_loss`` + ``get_eval`` on
   a 2-scene batch at the full-size spec, f32 with TF32 off, BN running
   statistics moved off their defaults.
4. Eval at full size: 32-scene batches (the bench's synthetic scenes) in the
   bf16 policy, three batches from distinct seeds, the first repeated;
   outputs finite, ``ref_iou`` in [0, 1], 26 kernel launches per forward;
   eval scenes/s and peak device memory.
5. K2, K3 and K1's f32 output vs their plain twins on the maps of the
   32-scene batch: K3 at the scene stem (K = 27, 7 -> 32) and the stage-1
   down (K = 8, 32 -> 64), K2 at the stage-1 (64 -> 64) and stage-3
   (128 -> 128) residuals, K1 over the stage-1 ``up8`` (64 -> 32, f32 out);
   f32 and bf16 inputs; two launches on the same inputs give bit-identical
   dW.  CUDA-event medians of 10.
6. Train parity, card vs CPU: one ``train_step`` on a 2-scene batch at the
   full-size spec, f32, TF32 off, deterministic cuDNN, dropout 0, the same
   weights: loss, every parameter gradient, the running statistics, then
   the parameters after a second Adam step.
7. Train at full size: 32-scene batches in the bf16 policy, one warm-up
   step, 5 timed steps, then one step on each of 2 more batches; loss and
   every gradient finite, ``ref_iou`` in [0, 1], 34 / 16 / 10 launches of
   K1 / K2 / K3 per step; train scenes/s and peak device memory.
8. The CLIs at full width: a fake ScanRefer root (40 000 points and 12
   instances a scene, the 18-class label map, 64 descriptions a scene as
   in ScanRefer: 16 train batches of 32 over 8 scenes, 8 val batches over
   4) and ``config/InstanceRefer.yaml`` as text with batch 32, 2 epochs,
   the lr milestone after epoch 1 and the fitted caps of
   ``config/band_profile.synthetic.yaml``.  ``main(argv)`` of train, eval
   (cold, then from its cache), train resumed for a third epoch, and one
   epoch with ``use_gt_lang: False``, each with the launch counters set to 0
   just before and read just after: 34 / 16 / 10 launches of K1 / K2 / K3
   per train step, 26 of K1 per eval forward, none from the cache.  The
   artifacts exist, every logged loss is finite, the lr is 1e-4 after the
   milestone and a resumed run goes on from epoch 3.  ``[cli]`` lines give
   the train CLI's scenes/s per iteration (fetch + step) in the steady
   state (every iteration but an epoch's first) and over its whole run
   (validation and checkpoints included), the eval CLI's scenes/s end to
   end, and the iter reports' means: fetch (split into the wait on the
   loader and ``batch_to_torch``), forward, backward, eval.

Then one line ``{"kernels": [...]}`` (launch counts of phase 7; ms and
plain_ms of K1 from phase 2, of K2 and K3 from phase 5, bf16 summed over
the shapes), the ``nvidia-smi`` line and, last, ``{"ok": true, "device":
...}``.  Weights are random (``torch.Generator`` seeds); scenes are
synthetic.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import tempfile
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
# K2/K3/K1-f32-out vs twin: |err| <= tol * max|ref|.  The outputs are f32 for
# both input types (bf16 inputs are exact in f32), so only the order of the
# f32 sums differs; dW sums over every row of the batch (up to 581632).
DX_TOL, DW_TOL = 1e-5, 1e-4
# train parity, card vs CPU (f32): the loss to LOSS_RTOL and the running
# statistics to STATS_RTOL (forward quantities, well conditioned).  The
# gradients of a 2-scene train step are not: max-pool winners and ReLU
# signs switch under rounding, and a BatchNorm over 2 rows has an
# analytically zero gradient held as rounding noise.  On the CPU, a 1e-6
# relative perturbation of the weights moved them by up to 1.2% of a
# layer's gradient norm and 0.7% overall (L2).  So each parameter's
# gradient must agree to GRAD_LAYER x the largest gradient norm of its
# layer, and all of them together to GRAD_ALL, in L2.  After the second
# Adam step each parameter lies within 2.5 x the summed lr + 1e-3 |p|: Adam
# moves an element by about +-lr whatever its gradient's size, so elements
# whose gradient is within rounding of 0 land on a coin flip, and the
# second step's gradients are taken at weights that already differ.  The
# mean difference over all elements must stay below ADAM_MEAN x lr (0.074
# lr measured on an H100; a wrong lr or moment on one side moves it to
# about lr).
LOSS_RTOL, STATS_RTOL, GRAD_LAYER, GRAD_ALL, ADAM_MEAN = 1e-4, 1e-3, 5e-2, 2e-2, 0.25
LR, WD = 1e-3, 1e-5  # config/InstanceRefer.yaml's Adam
TRAIN_LAUNCHES = {"gather_conv": 34, "subm_conv_bwd": 16, "conv_dw": 10}  # per train step


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


def phase_full(spec, dev, dds, model):
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype

    set_compute_dtype("bfloat16")
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
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


def _max_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def phase_bwd_kernels(batch, dev):
    """K3, K2 and K1's f32 output against their twins; returns per kernel
    the worst |err| and the bf16 times summed over its shapes."""
    from instancerefer_tpu_torch.data.host import voxelize
    from instancerefer_tpu_torch.ops import conv_bwd, sparse
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv

    def imap(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    rows = [batch[f"scene_nbr3_{s}"].shape[0] for s in range(5)]
    up8 = voxelize.build_up8(batch["scene_uprow_1"], batch["scene_upk_1"])
    f32_out = torch.float32
    # name: (kernel, twin, names of the outputs, their tolerances)
    kernels = {
        "conv_dw": (conv_bwd.conv_dw, sparse.conv_dw, ("dW",), (DW_TOL,)),
        "subm_conv_bwd": (conv_bwd.subm_conv_bwd, sparse.subm_conv_bwd, ("dX", "dW"),
                          (DX_TOL, DW_TOL)),
        "gather_conv": (lambda *a: gather_conv(*a, out_dtype=f32_out),
                        lambda *a: sparse.gather_conv(*a, out_dtype=f32_out), ("out",), (DX_TOL,)),
    }
    # (kernel, label, map, rows of the gathered input, cin, cout)
    cases = (
        ("conv_dw", "scene stem", imap(batch["scene_nbr3_0"]), rows[0], 7, 32),
        ("conv_dw", "scene stage1 down", imap(batch["scene_down_1"]), rows[0], 32, 64),
        ("subm_conv_bwd", "scene stage1 residual", imap(batch["scene_nbr3_1"]), rows[1], 64, 64),
        ("subm_conv_bwd", "scene stage3 residual", imap(batch["scene_nbr3_3"]), rows[3], 128, 128),
        ("gather_conv", "scene stage1 down dX over up8", imap(up8), rows[1], 64, 32),
    )
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {name: {"worst": 0.0, "ms": 0.0, "plain_ms": 0.0} for name in kernels}
    for name, label, nbr, v_in, cin, cout in cases:
        kern, twin, outs, tols = kernels[name]
        v_out, k = nbr.shape
        for dt in (torch.float32, torch.bfloat16):
            def rnd(*shape, scale=1.0):
                return (scale * torch.randn(*shape, device=dev, generator=gen)).to(dt)

            if name == "conv_dw":
                args = (rnd(v_in, cin), nbr, rnd(v_out, cout))
            elif name == "subm_conv_bwd":
                args = (rnd(v_out, cin), nbr, rnd(v_out, cout), rnd(k, cin, cout, scale=(k * cin) ** -0.5))
            else:
                args = (rnd(v_in, cin), nbr, rnd(k, cin, cout, scale=(k * cin) ** -0.5))
            def run(fn):
                out = fn(*args)
                return out if isinstance(out, tuple) else (out,)

            got, ref = run(kern), run(twin)
            again = run(kern) if outs[-1] == "dW" else None
            torch.cuda.synchronize()
            if again is not None and not torch.equal(got[-1], again[-1]):
                raise AssertionError(f"{name} at {label} {dt}: dW differs between two launches")
            t_k = median_ms(lambda: kern(*args))
            t_p = median_ms(lambda: twin(*args))
            for out_name, g, r, tol in zip(outs, got, ref, tols):
                err, scale = _max_err(g, r)
                log(f"[bwd-kernel] {name} {label} {out_name} V_out={v_out} K={k} {cin}->{cout} "
                    f"{str(dt)[6:]}: max_abs={err:.3e} max_rel={err / max(scale, 1e-30):.3e} "
                    f"(tol {tol:g} x max|ref|={scale:.3f})")
                if g.dtype != torch.float32 or not err <= tol * max(scale, 1e-30):
                    raise AssertionError(f"{name} disagrees with its twin at {label} {dt} {out_name}")
                res[name]["worst"] = max(res[name]["worst"], err)
            log(f"[bwd-kernel] {name} {label} {str(dt)[6:]}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f}"
                + ("" if again is None else "; dW bit-identical across two launches"))
            if dt == torch.bfloat16:  # the main path's type
                res[name]["ms"] += t_k
                res[name]["plain_ms"] += t_p
    return res


def phase_train_parity(spec, dev):
    from instancerefer_tpu_torch.data.host import batch_to_torch, make_batch
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    set_compute_dtype(None)
    torch.backends.cudnn.deterministic = True
    batch = make_batch(2, spec, seed=3, mean_size_arr=MEAN_SIZE, **SCENE_KW)
    cpu_model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                              generator=torch.Generator().manual_seed(4), dropout_override=0.0)
    models = {"cpu": cpu_model, "gpu": copy.deepcopy(cpu_model).to(dev)}
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    runs = {}
    for side, model in models.items():
        device = "cpu" if side == "cpu" else dev
        dd = batch_to_torch(batch, spec, device)
        opt = make_optimizer(model.parameters(), LR, WD)
        metrics, _ = train_step(model, opt, dd, ms.to(device))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for n, p in model.named_parameters()}
        stats = {n: b.detach().cpu().clone() for n, b in model.named_buffers() if "running" in n}
        train_step(model, opt, dd, ms.to(device))
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        runs[side] = (float(metrics["loss"]), grads, stats, params)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    (c_loss, c_grads, c_stats, c_params), (g_loss, g_grads, g_stats, g_params) = runs["cpu"], runs["gpu"]
    log(f"[train-parity] loss cpu={c_loss:.6f} gpu={g_loss:.6f} (rtol {LOSS_RTOL:g})")
    if not abs(g_loss - c_loss) <= LOSS_RTOL * abs(c_loss):
        raise AssertionError("card and CPU disagree on the train loss")
    layer_norm = {}
    for n, g in c_grads.items():
        layer = n.rsplit(".", 1)[0]
        layer_norm[layer] = max(layer_norm.get(layer, 0.0), g.norm().item())
    if max(layer_norm.values()) == 0:
        raise AssertionError("all gradients are zero")
    worst_rel, worst_abs, num, den = (0.0, ""), (0.0, ""), 0.0, 0.0
    for n, c in c_grads.items():
        d = (g_grads[n] - c).norm().item()
        rel = d / max(layer_norm[n.rsplit(".", 1)[0]], 1e-30)
        worst_rel = max(worst_rel, (rel, n))
        worst_abs = max(worst_abs, ((g_grads[n] - c).abs().max().item(), n))
        num, den = num + d * d, den + c.norm().item() ** 2
        if not rel <= GRAD_LAYER:
            raise AssertionError(f"card and CPU disagree on the gradient of {n}: "
                                 f"L2 error {rel:.3e} of its layer's gradient norm")
    overall = (num / den) ** 0.5
    log(f"[train-parity] {len(c_grads)} parameter gradients: L2 error overall {overall:.3e} "
        f"(limit {GRAD_ALL:g}), largest per layer {worst_rel[0]:.3e} at {worst_rel[1]} "
        f"(limit {GRAD_LAYER:g}); largest |err| {worst_abs[0]:.3e} at {worst_abs[1]}")
    if not overall <= GRAD_ALL:
        raise AssertionError("card and CPU gradients disagree overall")
    for n in c_stats:
        err = (g_stats[n] - c_stats[n]).abs()
        if not bool((err <= STATS_RTOL * c_stats[n].abs() + 1e-5).all()):
            raise AssertionError(f"card and CPU disagree on {n} (max |err| {err.max().item():.3e})")
    log(f"[train-parity] {len(c_stats)} running statistics agree (rtol {STATS_RTOL:g}, atol 1e-5)")
    total, tight, count = 0.0, 0, 0
    for n in c_params:
        diff = (g_params[n] - c_params[n]).abs()
        if not bool((diff <= 2.5 * 2 * LR + 1e-3 * c_params[n].abs()).all()):
            raise AssertionError(f"{n} after 2 Adam steps: max |diff| {diff.max().item():.3e}")
        total += diff.sum().item()
        tight += int((diff <= 0.1 * LR).sum())
        count += diff.numel()
    log(f"[train-parity] parameters after 2 Adam steps: mean |diff| {total / count / LR:.4f} lr "
        f"(limit {ADAM_MEAN:g}), {tight / count:.4f} of {count} elements within 0.1 lr, "
        f"all within 2.5 x the summed lr + 1e-3 |p|")
    if not total <= ADAM_MEAN * LR * count:
        raise AssertionError("card and CPU parameters drift apart over 2 Adam steps")


def phase_train(spec, dev, dds):
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    set_compute_dtype("bfloat16")
    model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                          generator=torch.Generator().manual_seed(5)).to(dev)
    opt = make_optimizer(model.parameters(), LR, WD)
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    counters = {"gather_conv": gather_conv, "subm_conv_bwd": conv_bwd.subm_conv_bwd,
                "conv_dw": conv_bwd.conv_dw}
    repeats = 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    results = []

    def check(metrics, out, grads=True):
        bad = [n for n, p in model.named_parameters() if grads and (
            p.grad is None or not bool(torch.isfinite(p.grad).all()))]
        if bad or not bool(torch.isfinite(metrics["loss"])):
            raise AssertionError(f"non-finite loss or gradients: {bad[:5]}")
        iou = out["ref_iou"]
        if iou.shape != (BATCH,) or not bool(((iou >= 0) & (iou <= 1)).all()):
            raise AssertionError("ref_iou outside [0, 1]")
        results.append({k: float(v) for k, v in metrics.items()})

    for f in counters.values():
        f.launches = 0
    check(*train_step(model, opt, dds[0], ms))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [train_step(model, opt, dds[0], ms) for _ in range(repeats)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i, (metrics, out) in enumerate(timed):  # the gradients are the last step's
        check(metrics, out, grads=i == repeats - 1)
    del timed
    for dd in dds[1:]:
        check(*train_step(model, opt, dd, ms))
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    n_steps = 1 + repeats + len(dds) - 1
    for k, per_step in TRAIN_LAUNCHES.items():
        if launches[k] != per_step * n_steps:
            raise AssertionError(f"{k}: {launches[k]} launches in {n_steps} train steps, "
                                 f"want {per_step} per step")
    peak = torch.cuda.max_memory_allocated(dev)
    for i, r in enumerate(results):
        log(f"[train] step {i}: loss={r['loss']:.4f} ref_loss={r['ref_loss']:.4f} "
            f"lang_loss={r['lang_loss']:.4f} seg_loss={r['seg_loss']:.4f} ref_acc={r['ref_acc']:.4f}")
    log(f"[train] B={BATCH} bf16: {n_steps} train steps, launches per step " + ", ".join(
        f"{k} {launches[k] // n_steps}" for k in counters) +
        f"; train {BATCH * repeats / dt:.2f} scenes/s (forward+get_loss+backward+Adam+get_eval, "
        f"mean over {repeats} steps, {dt / repeats * 1e3:.2f} ms/step); "
        f"peak device memory {peak / 2**20:.1f} MiB")
    set_compute_dtype(None)
    return launches


REPO = os.path.dirname(os.path.abspath(__file__))
# ScanRefer has 65-67 descriptions a scene in each split; the fake root has 64
CLI_SCENES = {"train": range(0, 8), "val": range(8, 12)}
CLI_BATCHES = {"train": 16, "val": 8}  # batches of BATCH a split
EVAL_LAUNCHES = {"gather_conv": CONVS_PER_FORWARD, "subm_conv_bwd": 0, "conv_dw": 0}
# (nyu40 id, nyu40 class) of the 18 classes: the tsv's columns 4 and 7; the
# last is not a class name and maps to "others"
NYU40 = ((3, "cabinet"), (4, "bed"), (5, "chair"), (6, "sofa"), (7, "table"), (8, "door"),
         (9, "window"), (10, "bookshelf"), (11, "picture"), (12, "counter"), (14, "desk"),
         (16, "curtain"), (24, "refrigerator"), (28, "shower curtain"), (33, "toilet"),
         (34, "sink"), (36, "bathtub"), (35, "lamp"))
WORDS = ("the", "a", "is", "it", "this", "that", "of", "to", "in", "on", "with", "and",
         "next", "near", "left", "right", "front", "behind", "corner", "room", "wall",
         "brown", "white", "black", "small", "large", "wooden", "square", "round", "facing")


def write_fake_scanrefer(root: str, rng: np.random.Generator) -> None:
    """The layout of ``tests/fake_scanrefer.py`` without its multiview file:
    per-scene PointGroup npys, the label tsv of the 18 classes, a GloVe
    pickle and ``ScanRefer_filtered_{split}.json``.  A scene is drawn as
    ``data/synthetic.py`` draws one: a 4 x 4 x 0.1 m floor of unlabelled
    points and 12 boxes of 256 points, 40 000 points in all; of its 12
    instances three pairs share a class and six are alone in theirs."""
    pg = os.path.join(root, "scannet", "pointgroup_data")
    meta = os.path.join(root, "scannet", "meta_data")
    os.makedirs(pg)
    os.makedirs(meta)
    n_inst, per_inst = SCENE_KW["num_instances"], 256
    n_floor = SCENE_KW["num_points"] - n_inst * per_inst
    slots = (0, 0, 1, 1, 2, 2, 3, 4, 5, 6, 7, 8)  # instance -> class slot of its scene
    objects = {}
    for si in range(max(CLI_SCENES["val"]) + 1):
        scene_id = f"scene{si:04d}_00"
        classes = rng.permutation(len(NYU40))[:max(slots) + 1]
        xyz = [rng.uniform([0, 0, 0], [4, 4, 0.1], size=(n_floor, 3))]
        ins, sem = [np.zeros(n_floor, np.int64)], [np.ones(n_floor, np.int64)]  # nyu40 1: wall
        boxes = []
        for i, slot in enumerate(slots):
            nyu = NYU40[classes[slot]][0]
            center = rng.uniform(0.5, 3.5, size=3)
            center[2] = rng.uniform(0.2, 1.5)
            pts = center + rng.uniform(-0.5, 0.5, size=(per_inst, 3)) * rng.uniform(0.2, 0.9, size=3)
            xyz.append(pts)
            ins.append(np.full(per_inst, i + 1, np.int64))
            sem.append(np.full(per_inst, nyu, np.int64))
            mn, mx = pts.min(0), pts.max(0)
            boxes.append(np.concatenate([(mn + mx) / 2, mx - mn, [nyu, i]]))
        xyz = np.concatenate(xyz)
        nrm = rng.normal(size=xyz.shape)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        verts = np.concatenate([xyz, rng.uniform(0, 255, size=xyz.shape), nrm], 1)
        np.save(os.path.join(pg, f"{scene_id}_aligned_vert.npy"), verts.astype(np.float32))
        np.save(os.path.join(pg, f"{scene_id}_ins_label_pg.npy"), np.concatenate(ins))
        np.save(os.path.join(pg, f"{scene_id}_sem_label_pg.npy"), np.concatenate(sem))
        np.save(os.path.join(pg, f"{scene_id}_aligned_bbox.npy"), np.stack(boxes))
        objects[si] = [NYU40[classes[slot]][1] for slot in slots]

    with open(os.path.join(meta, "scannetv2-labels.combined.tsv"), "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id\tnyuClass\tnyu40class\n")
        for i, (nyu, name) in enumerate(NYU40):
            f.write(f"{i + 1}\t{name}\t{name}\t1\t{nyu}\t0\t{name}\t{name}\n")
    vocab = set(WORDS) | {w for _, name in NYU40 for w in name.split()} | {"unk"}
    with open(os.path.join(root, "glove.p"), "wb") as f:
        pickle.dump({w: rng.normal(size=300).astype(np.float32) for w in sorted(vocab)}, f)
    for split, scenes in CLI_SCENES.items():
        anns, seen = [], {}
        for _ in range(CLI_BATCHES[split] * BATCH):
            si = int(rng.choice(scenes))
            obj = int(rng.integers(n_inst))
            name = objects[si][obj]
            ann_id = seen[si, obj] = seen.get((si, obj), -1) + 1
            tokens = [str(w) for w in rng.choice(WORDS, size=int(rng.integers(6, 40)))]
            tokens[1:1] = name.split()
            anns.append({"scene_id": f"scene{si:04d}_00", "object_id": str(obj),
                         "object_name": name.replace(" ", "_"), "ann_id": str(ann_id),
                         "token": tokens, "description": " ".join(tokens)})
        with open(os.path.join(root, f"ScanRefer_filtered_{split}.json"), "w") as f:
            json.dump(anns, f)


def cli_config_text() -> str:
    """``config/InstanceRefer.yaml`` with batch 32, 2 epochs, the lr milestone
    after epoch 1, an iter report every step, and the synthetic band
    profile's fitted caps."""
    text = open(os.path.join(REPO, "config", "InstanceRefer.yaml")).read()
    for old, new in (("batch_size: 64", f"batch_size: {BATCH}"), ("epoch: 25", "epoch: 2"),
                     ("lr_decay_step: [15, 20]", "lr_decay_step: [1]"), ("verbose: 20", "verbose: 1")):
        if text.count(old) != 1:
            raise AssertionError(f"config/InstanceRefer.yaml: {old!r} not found once")
        text = text.replace(old, new)
    if not text.rstrip().splitlines()[-1].startswith("  "):
        raise AssertionError("config/InstanceRefer.yaml no longer ends in its TPU section")
    return text + f"  band_profile: {os.path.join(REPO, 'config', 'band_profile.synthetic.yaml')}\n"


def _records(run: str):
    with open(os.path.join(run, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_cli():
    import warnings

    from instancerefer_tpu_torch.config import load_config
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.scripts import eval as eval_cli
    from instancerefer_tpu_torch.scripts import train as train_cli

    counters = {"gather_conv": gather_conv, "subm_conv_bwd": conv_bwd.subm_conv_bwd,
                "conv_dw": conv_bwd.conv_dw}
    root = tempfile.mkdtemp(prefix="cli_smoke_")
    try:
        t0 = time.perf_counter()
        write_fake_scanrefer(root, np.random.default_rng(0))
        configs = {"main": cli_config_text()}
        configs["predicted"] = configs["main"].replace("use_gt_lang: True", "use_gt_lang: False") \
            .replace("epoch: 2", "epoch: 1")
        for name, text in configs.items():
            with open(os.path.join(root, f"{name}.yaml"), "w") as f:
                f.write(text)
        log(f"[cli] fake ScanRefer root ({len(CLI_SCENES['train'])} train and "
            f"{len(CLI_SCENES['val'])} val scenes, {CLI_BATCHES['train']} and "
            f"{CLI_BATCHES['val']} batches of {BATCH}) written in {time.perf_counter() - t0:.1f} s")

        def argv(config, log_dir):
            return ["--config", os.path.join(root, f"{config}.yaml"), "--log_dir", log_dir,
                    "--data_root", root, "--output_root", os.path.join(root, "outputs"),
                    "--device", "cuda"]

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the profile overrides the yaml's caps, on purpose
            spec = load_config(argv("main", "x")).batch_spec()
        for k, v in SPEC_KW.items():
            if getattr(spec, k) != v:
                raise AssertionError(f"the CLI config's {k} is {getattr(spec, k)}, want {v}")

        def drive(label, fn, args, want_per_step):
            """One CLI ``main`` with the launch counters set to 0 just before
            and read just after; ``want_per_step(result)`` gives the launches
            it must have made.  Its standard output is kept back, and shown
            if it fails."""
            for f in counters.values():
                f.launches = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = io.StringIO()
            try:
                with warnings.catch_warnings(), contextlib.redirect_stdout(out):
                    warnings.simplefilter("ignore")
                    result = fn(args)
            except BaseException:
                log(out.getvalue()[-4000:])
                raise
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            got = {k: f.launches for k, f in counters.items()}
            want = want_per_step(result)
            log(f"[cli] {label}: {wall:.1f} s wall, launches " +
                ", ".join(f"{k} {got[k]}" for k in counters))
            if got != want:
                raise AssertionError(f"{label}: launches {got}, want {want}")
            return result, wall

        def train_launches(epochs):
            def want(solver):
                n_train, n_val = solver.steps["train"], solver.steps["val"]
                if n_train != CLI_BATCHES["train"] * epochs or n_val != CLI_BATCHES["val"] * epochs:
                    raise AssertionError(f"{n_train} train and {n_val} val steps in {epochs} epochs")
                return {k: TRAIN_LAUNCHES[k] * n_train + EVAL_LAUNCHES[k] * n_val for k in counters}
            return want

        solver, train_wall = drive("train", train_cli.main, argv("main", "cli"), train_launches(2))
        run = solver.root
        for name in ("model_last.pth", "model.pth", "checkpoint.tar", "log.txt", "scalars.jsonl",
                     "best.txt", "info.json"):
            if not os.path.isfile(os.path.join(run, name)):
                raise AssertionError(f"train wrote no {name}")
        records = _records(run)
        bad = [r for r in records for k in ("loss", "ref_loss", "lang_loss", "seg_loss")
               if not np.isfinite(r[k])]
        per_epoch = CLI_BATCHES["train"]
        if bad or len(records) != 2 * (per_epoch + 1):
            raise AssertionError(f"{len(records)} records, non-finite losses in {bad[:2]}")
        lrs = [r["lr"] for r in records if r["phase"] == "train"]
        if not np.allclose(lrs, [1e-3] * per_epoch + [1e-4] * per_epoch, rtol=1e-9, atol=0):
            raise AssertionError(f"lr per train step {lrs}")

        n_val = CLI_BATCHES["val"] * BATCH
        _, eval_wall = drive("eval (cold)", eval_cli.main, argv("main", "cli"),
                             lambda _: {k: EVAL_LAUNCHES[k] * CLI_BATCHES["val"] for k in counters})
        scores = np.load(os.path.join(run, "scores.npz"))
        if len(scores["ref_iou"]) != n_val or not np.isfinite(scores["ref_iou"]).all():
            raise AssertionError("scores.npz: wrong length or non-finite ious")
        table, _ = drive("eval (cached)", eval_cli.main, argv("main", "cli"),
                         lambda _: {k: 0 for k in counters})
        if table["overall"]["overall"]["count"] != n_val:
            raise AssertionError("the cached table does not count every description")

        with open(os.path.join(root, "resume.yaml"), "w") as f:
            f.write(configs["main"].replace(
                "epoch: 2", f"epoch: 3\n  use_checkpoint: {os.path.basename(run)}"))
        resumed, _ = drive("train resumed", train_cli.main, argv("resume", "cli"),
                          train_launches(1))
        text = open(os.path.join(resumed.root, "log.txt")).read()
        first = _records(resumed.root)[0]
        if resumed.root == run or "epoch 3 starting" not in text or "epoch 2 starting" in text \
                or first["iter"] != 2 * per_epoch or abs(first["lr"] - 1e-4) > 1e-12:
            raise AssertionError("the resumed run does not go on from epoch 3")
        drive("train use_gt_lang False", train_cli.main, argv("predicted", "clipred"),
              train_launches(1))

        text = open(os.path.join(run, "log.txt")).read()
        reports = {k: np.array([float(v) for v in
                                re.findall(rf"\[info\] mean_{k}_time: (\S+)s", text)])
                   for k in ("fetch", "fetch_load", "fetch_copy", "forward", "backward", "eval",
                             "iter")}
        if any(len(v) != 2 * per_epoch for v in reports.values()):
            raise AssertionError("the train log holds no iter report for every iteration")
        # an epoch's first fetch waits for the loader to start and for two batches
        steady = np.arange(2 * per_epoch) % per_epoch != 0
        log(f"[cli] train B={BATCH}: {BATCH / reports['iter'][steady].mean():.2f} scenes/s "
            f"per iteration (fetch + step) in the steady state, the mean of {steady.sum()} "
            f"iterations; {BATCH / reports['iter'].mean():.2f} over all {steady.size}; "
            f"{steady.size * BATCH / train_wall:.2f} over the CLI's wall time of "
            f"{train_wall:.2f} s (setup, validation and checkpoints included)")
        log("[cli] train iter report, steady-state means: " + ", ".join(
            f"{k} {v[steady].mean() * 1e3:.2f} ms" for k, v in reports.items())
            + "; each epoch's first iteration: " + ", ".join(
            f"fetch {f * 1e3:.1f} ms" for f in reports["fetch"][~steady]))
        log(f"[cli] eval B={BATCH}: {n_val / eval_wall:.2f} scenes/s end to end "
            f"({n_val} descriptions in {eval_wall:.2f} s: dataset, weights, host "
            f"pipeline, forwards and scores.npz)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        set_compute_dtype(None)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from instancerefer_tpu_torch.data.host import BatchSpec, batch_to_torch, make_batch, voxelize
    from instancerefer_tpu_torch.ops import gather_conv as gc_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] host voxelizer native: {voxelize.native_available()}")
    t0 = time.perf_counter()
    libs = gc_mod.build()
    log(f"[build] {', '.join(sorted(libs))} ready in {time.perf_counter() - t0:.1f} s")

    spec = BatchSpec(**SPEC_KW)
    t0 = time.perf_counter()
    batches = [make_batch(BATCH, spec, seed=s, mean_size_arr=MEAN_SIZE, **SCENE_KW)
               for s in (0, 1, 2)]
    dds = [batch_to_torch(b, spec, dev) for b in batches]
    log(f"[host] 3 batches of {BATCH} scenes built in {time.perf_counter() - t0:.1f} s")

    worst, ms, plain_ms = phase_kernel(batches[0], dev)
    phase_parity(spec, dev)
    phase_full(spec, dev, dds, make_model(spec, seed=2).to(dev))
    bwd = phase_bwd_kernels(batches[0], dev)
    phase_train_parity(spec, dev)
    launches = phase_train(spec, dev, dds)
    del dds
    phase_cli()

    k1 = {"worst": max(worst, bwd["gather_conv"]["worst"]), "ms": ms, "plain_ms": plain_ms}
    entries = (
        ("gather_conv", "gather_conv.cu", 51, k1),
        ("subm_conv_bwd", "subm_conv_bwd.cu", 267, bwd["subm_conv_bwd"]),
        ("conv_dw", "conv_dw.cu", 440, bwd["conv_dw"]),
    )
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"instancerefer_tpu_torch/csrc/{src}",
        "replaces": f"instancerefer_tpu/ops/pallas_conv.py:{line}",
        "launches": launches[name],
        "max_abs_err": r["worst"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
    } for name, src, line, r in entries]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
