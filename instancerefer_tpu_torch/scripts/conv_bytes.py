"""Count what the tensor-core gather-GEMM (K1, K2's dX), K2's dW, the downs'
dX over their lists and K3 at the down convs move, by shape, on the
bench's synthetic batch: the bytes each stages from L2 into shared memory
under this tree's plans, beside each shape's valid map entries and its
bound.

    python -m instancerefer_tpu_torch.scripts.conv_bytes [--batch 64] [--sms 132]
    python -m instancerefer_tpu_torch.scripts.conv_bytes --pointgroup [--sms 132]

Runs on the CPU (numpy; no card).  The batch is ``scripts/bench.py``'s:
``config/band_profile.synthetic.yaml``'s caps, 40 000-point scenes, seed 0.
For every K1 tensor-core shape of a train step but the downs' dX, and
every K2 shape (``scripts/step_ab.SHAPES``), one line, then the totals of
a train step and the bound of a step by kernel (every launch of a train
and an eval step, the stems at Cin 7):

- ``valid``: the map's valid entries; ``bound_ms``: ``step_ab.shape_bounds``
  (an H100's peaks);
- the plan (``gather_conv.tc_plan``; K2 also ``conv_bwd.dw_plan``);
- K1 / K2's dX: the gathered rows staged (``rows_MB``; -1 rows are
  zero-filled but staged), per (64-row tile, offset) pair with a valid
  index in the tile; the weight slices staged per such pair (``w_MB``);
  ``w_share``, W's part of the staged bytes;
- K2's dW: x tiles staged (``x_MB``), gathered g rows (``g_MB``), map
  bytes read in 32-byte sectors (``map_MB``; a row's G entries side by
  side, read once a tile) and the split partials written and read
  (``partial_MB``).

Then the downs' dX over the per-offset lists of the down map
(``conv_bwd.down_dx``, ``dx_list_splits`` blocks a list): the valid
entries' g rows staged (``rows_MB``), W[k] staged once a block (``w_MB``),
the list and map entries read (``index_MB``, one 32-byte sector a map
entry), ``up8`` read by the zero pass (``up8_MB``) and the bf16 dX written
(``dx_MB``: the named rows and the zeroed ones), beside what K1's grid of
64-row tiles over ``up8`` with its 16-row slice checks staged for it
(``grid_MB``: the gathered rows of every (16-row slice, offset) pair with
a valid index and the weight slices of every (tile, offset) pair).

Then K3 at each down conv, over the per-offset lists
(``conv_bwd.dw_list_splits``): the x and g rows staged (``rows_MB``, the
valid entries' rows; a list's last tile's zero rows read nothing), beside
what the kernel this tree replaced staged (``grid_MB``: every (64-row
tile, offset) pair with a valid index, all 64 rows of x and g); the list
pass's reads of the map (``map_MB``, once in each of its two kernels) and
its writes of the lists (``lists_MB``); the dW kernel's reads of the lists
and of the map entries they name (``index_MB``, one 32-byte sector a map
entry); the split partials written and read (``partial_MB``).

``--pointgroup`` counts K2's dW alone instead, at every submanifold pair of
PointGroup's U-Net over its level's map in the cell
``pointgroup-train-resident`` (``step_ab.pointgroup_levels``: the first
pool batch of seed 15, 4 rooms at the configuration's capacities): the
x, g, map and partial bytes under the rule's G (``conv_bwd.dw_plan``) and
at two offsets a block, with their launches a step (a level's seven c -> c
convs and one 2c -> c, the last level's four c -> c) and a step's totals.
"""

from __future__ import annotations

import argparse

import numpy as np

BM = 64  # the rows of a tile of the gather-GEMM and of K2's dW


def active_pairs(nbr: np.ndarray, bm: int) -> np.ndarray:
    """[tiles, K] bool: (tile of ``bm`` rows, offset) with a valid index."""
    v, k = nbr.shape
    tiles = -(-v // bm)
    pad = np.full((tiles * bm, k), -1, np.int32)
    pad[:v] = nbr
    return (pad.reshape(tiles, bm, k) >= 0).any(1)


def gemm_bytes(nbr, red: int, nout: int):
    """(rows, weight) bytes the gather-GEMM stages: the rows of every
    (tile, offset) pair with a valid index, and W per such pair."""
    pairs = int(active_pairs(nbr, BM).sum())
    return pairs * BM * red * 2, pairs * red * nout * 2


def dw_bytes(nbr, cin: int, cout: int, group: int, splits: int):
    """(x, g, map, partial) bytes of K2's dW with ``group`` offsets a block."""
    v, k = nbr.shape
    act = active_pairs(nbr, BM)
    x = g = mapb = 0
    for k0 in range(0, k, group):
        cols = act[:, k0:k0 + group]
        x += int(cols.any(1).sum()) * BM * cin * 2
        g += int(cols.sum()) * BM * cout * 2
        first = (np.arange(v) * k + k0) * 4 // 32
        last = (np.arange(v) * k + min(k, k0 + group) - 1) * 4 // 32
        mapb += int((last - first + 1).sum()) * 32
    return x, g, mapb, 2 * splits * k * cin * cout * 4


def list_dw_bytes(nbr, cin: int, cout: int, splits: int) -> dict:
    """What K3 moves at a down conv over the per-offset lists, by kind (see
    the module's note), and ``grid``, what the (K, split) grid of 64-row
    tiles it replaced staged."""
    v, k = nbr.shape
    nnz = int((nbr >= 0).sum())
    return {"rows": nnz * (cin + cout) * 2,
            "grid": int(active_pairs(nbr, BM).sum()) * BM * (cin + cout) * 2,
            "map": 2 * nbr.nbytes, "lists": nnz * 4, "index": nnz * (4 + 32),
            "partial": 2 * splits * k * cin * cout * 4}


def list_dx_bytes(down, up8, cin: int, cout: int, splits: int) -> dict:
    """What the list-driven dX moves at a down conv (``down`` [V_out, 8],
    its inverse ``up8`` [V_in, 8]; the conv's Cin -> Cout), by kind (see the
    module's note), and ``grid``, what K1 over ``up8`` with W^T staged."""
    nnz = int((down >= 0).sum())
    grid = int(active_pairs(up8, 16).sum()) * 16 * cout * 2 + \
        int(active_pairs(up8, BM).sum()) * cout * cin * 2
    return {"rows": nnz * cout * 2, "w": down.shape[1] * splits * cin * cout * 2,
            "index": nnz * (4 + 32), "up8": up8.nbytes, "dx": up8.shape[0] * cin * 2,
            "grid": grid}


def pointgroup_dw(sms: int) -> None:
    """K2's dW bytes at PointGroup's submanifold pairs (``--pointgroup``):
    under the rule's G, and, where the warps split a block's offsets (WG >
    1), at two offsets a block; a step's totals of each (the pairs of WG =
    1 at the rule's in both)."""
    import torch

    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.scripts import step_ab

    levels = step_ab.pointgroup_levels(torch.device("cpu"))
    mb = 1e-6
    totals = {"rule": 0, "two a block": 0}
    print(f"{step_ab.PG_WORKLOAD}, seed {step_ab.PG_SEED}'s first batch, {sms} SMs; K2's dW, "
          f"MB staged from L2 into shared memory (x, g, map sectors) and partials written and "
          f"read")
    for lvl, (rows, nbr) in enumerate(levels):
        nbr = nbr.numpy()
        c = 16 * (lvl + 1)
        last = lvl == len(levels) - 1
        for cin, launches in ((c, 4 if last else 7),) + (() if last else ((2 * c, 1),)):
            k = nbr.shape[1]
            rule = conv_bwd.dw_group(cin, c)
            wide = conv_bwd.dw_group_split(cin, c)[2] == 1
            line = (f"level {lvl} {cin}->{c}: V={rows} valid={int((nbr >= 0).sum())} "
                    f"launches={launches}")
            for name, group in (("rule", rule), ("two a block", rule if wide else 2)):
                splits = conv_bwd.dw_group_splits(rows, k, cin, c, sms, group)
                x, g, m, part = dw_bytes(nbr, cin, c, group, splits)
                totals[name] += launches * (x + g + m + part)
                if name == "rule" or not wide:
                    line += (f"; {name} G={group} splits={splits}: x_MB {x * mb:.1f} g_MB "
                             f"{g * mb:.1f} map_MB {m * mb:.1f} partial_MB {part * mb:.1f}")
            print(line)
    print("a train step, MB: " + ", ".join(f"{name} {b * mb:.1f}" for name, b in totals.items()))


def main(argv=None) -> None:
    import torch

    from instancerefer_tpu_torch.config import band_profile_kwargs
    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops import gather_conv as G
    from instancerefer_tpu_torch.scripts import bench, step_ab

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64, help="scenes a batch (the bench's 64)")
    ap.add_argument("--sms", type=int, default=132, help="the card's SMs (an H100 SXM's 132)")
    ap.add_argument("--pointgroup", action="store_true",
                    help="K2's dW at PointGroup's submanifold pairs in its cell instead")
    args = ap.parse_args(argv)
    if args.pointgroup:
        pointgroup_dw(args.sms)
        return
    caps = band_profile_kwargs(bench.PROFILE)
    spec = BatchSpec(**{k: caps[k] for k in ("scene_caps", "inst_caps", "max_candidates",
                                            "max_instances")})
    batch = make_batch(args.batch, spec, seed=0, mean_size_arr=bench.MEAN_SIZE, **bench.SCENE_KW)
    bounds = step_ab.shape_bounds(batch)
    mb = 1e-6
    totals = {"K1": 0.0, "K2 dX": 0.0, "K2 dW": 0.0}
    print(f"B={args.batch}, {args.sms} SMs; MB staged from L2 into shared memory")
    for label, wrapper, key, _, cin, cout in step_ab.SHAPES:
        if wrapper not in ("gather_conv", "subm_conv_bwd") or cin not in G.TC_WIDTHS:
            continue
        nbr = step_ab.shape_map(batch, key)
        v, k = nbr.shape
        nnz, bound_ms = bounds[label]
        launches = 2 if "residual" in label else 1
        red, nout = (cout, cin) if wrapper == "subm_conv_bwd" else (cin, cout)
        plan = G.tc_plan(v, k, red, nout, torch.bfloat16, args.sms)
        rows, w = gemm_bytes(nbr, red, nout)
        line = (f"{label}: V={v} K={k} {cin}->{cout} valid={nnz} bound_ms={bound_ms:.4f} "
                f"launches={launches} plan={plan.bm}x{plan.cluster}; "
                f"{'dX ' if wrapper == 'subm_conv_bwd' else ''}rows_MB {rows * mb:.1f} "
                f"w_MB {w * mb:.1f} w_share {w / (rows + w):.3f}")
        totals["K2 dX" if wrapper == "subm_conv_bwd" else "K1"] += launches * (rows + w)
        if wrapper == "subm_conv_bwd":
            dwp = conv_bwd.dw_plan(v, k, cin, cout, args.sms)
            x, g, m, part = dw_bytes(nbr, cin, cout, dwp.group, dwp.splits)
            line += (f"; dW G={dwp.group} splits={dwp.splits}: x_MB {x * mb:.1f} "
                     f"g_MB {g * mb:.1f} map_MB {m * mb:.1f} partial_MB {part * mb:.1f}")
            totals["K2 dW"] += launches * (x + g + m + part)
        print(line)
    dx = dict.fromkeys(("rows", "w", "index", "up8", "dx", "grid"), 0)
    for label, wrapper, key, in_key, cin, cout in step_ab.SHAPES:
        if wrapper != "gather_conv_dx" or cin not in G.TC_WIDTHS:
            continue
        up8 = step_ab.shape_map(batch, key)
        down = step_ab.shape_map(batch, key.replace("_up8_", "_down_"))
        nnz, bound_ms = bounds[label]
        splits = conv_bwd.dx_list_splits(down.shape[0], 8, cout, cin, args.sms)
        b = list_dx_bytes(down, up8, cout, cin, splits)
        for kind, n in b.items():
            dx[kind] += n
        print(f"{label}, over the lists: V_in={up8.shape[0]} V_out={down.shape[0]} "
              f"{cin}->{cout} valid={nnz} zeroed rows={up8.shape[0] - nnz} bound_ms={bound_ms:.4f} "
              f"splits={splits}; " + " ".join(f"{kind}_MB {n * mb:.1f}" for kind, n in b.items()))
    totals["K1 dX over the lists"] = sum(n for kind, n in dx.items() if kind != "grid")
    k3 = dict.fromkeys(("rows", "grid", "map", "lists", "index", "partial"), 0)
    for label, wrapper, key, _, cin, cout in step_ab.SHAPES:
        if wrapper != "conv_dw" or cin not in G.TC_WIDTHS:
            continue
        nbr = step_ab.shape_map(batch, key)
        v, k = nbr.shape
        nnz, bound_ms = bounds[label]
        splits = conv_bwd.dw_list_splits(v, k, cin, cout, args.sms)
        b = list_dw_bytes(nbr, cin, cout, splits)
        for kind, n in b.items():
            k3[kind] += n
        print(f"{label}: V={v} K={k} {cin}->{cout} valid={nnz} fill={nnz / (v * k):.3f} "
              f"bound_ms={bound_ms:.4f} splits={splits}; " + " ".join(
                  f"{kind}_MB {n * mb:.1f}" for kind, n in b.items()))
    totals["K3 downs"] = sum(n for kind, n in k3.items() if kind != "grid")
    print("a train step, MB: " + ", ".join(f"{fam} {b * mb:.1f}" for fam, b in totals.items())
          + f" (the downs' dX: g rows {dx['rows'] * mb:.1f}, W {dx['w'] * mb:.1f}, dX "
          f"written {dx['dx'] * mb:.1f}, where K1's grid of tiles over up8 staged "
          f"{dx['grid'] * mb:.1f}; K3 at the downs: rows {k3['rows'] * mb:.1f}, where the grid "
          f"of tiles staged {k3['grid'] * mb:.1f})")
    # the bound of a step by kernel: every launch at Cin 7 (the default stems)
    steps = {"K1 train": 0.0, "K1 eval": 0.0, "K2": 0.0, "K3": 0.0}
    for label, wrapper, *_ in step_ab.SHAPES:
        if "Cin" in label:  # the stems at the other input widths
            continue
        b_ms = bounds[label][1] * (2 if "residual" in label else 1)
        kernel = label.split()[0]
        if kernel == "K1":
            steps["K1 train"] += b_ms
            steps["K1 eval"] += b_ms if wrapper == "gather_conv" else 0.0
        else:
            steps[kernel] += b_ms
    print("bound ms a step (every launch, Cin 7): " + ", ".join(
        f"{k} {v:.4f}" for k, v in steps.items()))


if __name__ == "__main__":
    main()
