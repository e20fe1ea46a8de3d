"""Weights in the reference's layout, and weights carried from the JAX package.

Every file the port writes or reads holds a state_dict in the reference's
layout: the names and tensor layouts of the reference's torch model, which is
also what the JAX package's exporter writes
(``instancerefer_tpu/utils/convert_torch.export_state_dict``, of which
``export_state_dict`` here is the port's own copy).  The port's sparse-conv
kernels (``*.net.*.kernel``, [K, Cin, Cout]) are indexed in the host maps'
offset order (``ops/voxelize.KERNEL_OFFSETS_3/2``), the reference's in
torchsparse's; ``_PERM3``/``_PERM2`` map one onto the other, found by
matching offset vectors.  Both orders are
x-fastest today, so the permutations are the identity and a bare
``load_state_dict`` of a reference file happens to be right; a change to
either order would make it load without complaint and convolve wrongly.  So
every file goes through the permutation:

* ``to_reference_state_dict(model)`` writes the kernels in torchsparse's
  order (the permutations inverted);
* ``load_reference_state_dict(model, sd)`` permutes them back and loads;
* ``state_dict_from_jax(params, batch_stats)`` is ``export_state_dict``
  followed by the load-side permutation (the tests' bridge from JAX
  weights).

JAX gradients (and Adam's moments) have the tree of the params, so
``state_dict_from_jax(grads, batch_stats)`` names them as the port's
parameters, with the same layout changes and kernel permutation; the tests
hold the port's gradients and trajectories against JAX's that way.

ENet (``models/enet.py``) keeps the reference's module tree, so its
published weights (``scannetv2_enet.pth``) need no conversion:
``load_enet`` is a strict ``load_state_dict``.  ``enet_state_dict_from_jax``
turns the JAX ``Enet``'s variables (the tree that
``scripts/convert_enet.convert_state_dict`` writes) back into that state
dict.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from instancerefer_tpu_torch.models.enet import BOTTLENECK_PLAN, FIRST_BOTTLENECK_INDEX, Enet
from instancerefer_tpu_torch.ops.voxelize import KERNEL_OFFSETS_2, KERNEL_OFFSETS_3


def torchsparse_offsets(kernel_size: int) -> np.ndarray:
    """torchsparse-1.2 kernel offset enumeration (``kernel_region.py``):
    per-axis offsets ``-ks//2+1 .. ks//2`` for odd ks, ``0 .. ks-1`` for even
    ks, composed x-fastest."""
    if kernel_size % 2:
        axis = np.arange(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        axis = np.arange(0, kernel_size)
    return np.array([[x, y, z] for z in axis for y in axis for x in axis], np.int32)


def _offset_permutation(ks: int, ours: np.ndarray) -> np.ndarray:
    """perm with ours[k] == torchsparse_offsets(ks)[perm[k]]."""
    index = {tuple(o): i for i, o in enumerate(torchsparse_offsets(ks))}
    perm = np.array([index[tuple(o)] for o in ours], np.int64)
    if len(set(perm.tolist())) != len(perm):
        raise AssertionError("offset permutation is not a bijection")
    return perm


_PERM3 = _offset_permutation(3, KERNEL_OFFSETS_3)
_PERM2 = _offset_permutation(2, KERNEL_OFFSETS_2)

# encoder member -> (flax block, flax leaf-module) of SparseConvEncoder /
# BEVEncoder (reference models/basic_blocks.py:14-56: Sequential indices
# 0=conv, 1=bn inside BasicConvolutionBlock.net; 0, 1, 3, 4 inside
# ResidualBlock.net)
_ENCODER_SITES = {
    ("stem", "0", "net", "0"): ("stem", "conv"),
    ("stem", "0", "net", "1"): ("stem", "bn"),
    **{
        (f"stage{n}", seq, "net", idx): (f"stage{n}_{blk}", leaf)
        for n in (1, 2, 3, 4)
        for seq, idx, blk, leaf in (
            ("0", "0", "down", "conv"),
            ("0", "1", "down", "bn"),
            ("1", "0", "res", "conv1"),
            ("1", "1", "res", "bn1"),
            ("1", "3", "res", "conv2"),
            ("1", "4", "res", "bn2"),
        )
    },
}

# module-local Sequential index -> (kind, flax name), per reference module
_HEAD_SITES = {
    "lang": {
        ("word_projection", "0"): ("linear", "word_projection_0"),
        ("word_projection", "3"): ("linear", "word_projection_1"),
        ("fc_a",): ("linear", "fc_a"),
        ("fc_cls",): ("linear", "fc_cls"),
        ("fc_rel",): ("linear", "fc_rel"),
        ("fc_scene",): ("linear", "fc_scene"),
        ("lang_cls", "0"): ("linear", "lang_cls"),
    },
    "attribute": {
        ("vis_emb_fc", "0"): ("linear", "vis_emb_fc_0"),
        ("vis_emb_fc", "1"): ("norm", "vis_emb_fc_ln"),
        ("vis_emb_fc", "3"): ("linear", "vis_emb_fc_1"),
        ("lang_emb_fc", "0"): ("linear", "lang_emb_fc_0"),
        ("lang_emb_fc", "1"): ("batchnorm", "lang_emb_fc_bn"),
        ("lang_emb_fc", "3"): ("linear", "lang_emb_fc_1"),
    },
    "relation": {
        ("vis_emb_fc", "0"): ("linear", "vis_emb_fc_0"),
        ("vis_emb_fc", "1"): ("norm", "vis_emb_fc_ln"),
        ("vis_emb_fc", "4"): ("linear", "vis_emb_fc_1"),
        ("lang_emb_fc", "0"): ("linear", "lang_emb_fc_0"),
        ("lang_emb_fc", "1"): ("batchnorm", "lang_emb_fc_bn"),
        ("lang_emb_fc", "4"): ("linear", "lang_emb_fc_1"),
        ("gcn", "mlp", "0"): ("linear", "gcn/mlp_0"),
        ("gcn", "mlp", "2"): ("linear", "gcn/mlp_1"),
        ("gcn", "weight", "0"): ("linear", "gcn/weight_0"),
        ("gcn", "weight", "2"): ("linear", "gcn/weight_1"),
    },
    "scene": {
        ("to_bev", "1"): ("bev_kernel", "to_bev_conv"),
        ("to_bev", "2"): ("batchnorm", "to_bev_bn"),
        ("vis_emb_fc", "0"): ("conv2d", "vis_emb_fc_conv0/conv"),
        ("vis_emb_fc", "1"): ("batchnorm", "vis_emb_fc_bn"),
        ("vis_emb_fc", "4"): ("conv2d", "vis_emb_fc_conv1/conv"),
        ("vis_emb_fc1", "0"): ("linear", "vis_emb_fc1_0"),
        ("vis_emb_fc1", "1"): ("norm", "vis_emb_fc1_ln"),
        ("vis_emb_fc1", "4"): ("linear", "vis_emb_fc1_1"),
        ("lang_emb_fc", "0"): ("linear", "lang_emb_fc_0"),
        ("lang_emb_fc", "1"): ("norm", "lang_emb_fc_ln"),
        ("lang_emb_fc", "4"): ("linear", "lang_emb_fc_1"),
        ("cls", "0"): ("linear", "cls_0"),
        ("cls", "1"): ("batchnorm", "cls_bn"),
        ("cls", "3"): ("linear", "cls_1"),
    },
}


def export_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, np.ndarray]:
    """flax ``(params, batch_stats)`` as numpy trees -> a reference-named,
    reference-layout state_dict (numpy leaves): Linear kernels transposed,
    LayerNorm/BatchNorm ``scale`` -> ``weight`` and ``mean``/``var`` ->
    ``running_*``, Conv2d kernels HWIO -> OIHW, GRU ``wx``/``wh`` transposed
    into ``weight_ih``/``weight_hh``, and sparse kernels put in
    torchsparse's offset order.  Modules absent from ``params`` are skipped."""
    sd: Dict[str, np.ndarray] = {}

    def get(tree, path):
        node = tree
        for p in path.split("/"):
            node = node[p]
        return np.asarray(node)

    def emit(kind, ref, base):
        if kind == "linear":
            sd[f"{ref}.weight"] = np.ascontiguousarray(get(params, f"{base}/kernel").T)
            sd[f"{ref}.bias"] = get(params, f"{base}/bias")
        elif kind == "norm":
            sd[f"{ref}.weight"] = get(params, f"{base}/scale")
            sd[f"{ref}.bias"] = get(params, f"{base}/bias")
        elif kind == "batchnorm":
            sd[f"{ref}.weight"] = get(params, f"{base}/scale")
            sd[f"{ref}.bias"] = get(params, f"{base}/bias")
            sd[f"{ref}.running_mean"] = get(batch_stats, f"{base}/mean")
            sd[f"{ref}.running_var"] = get(batch_stats, f"{base}/var")
            sd[f"{ref}.num_batches_tracked"] = np.asarray(0, np.int64)
        elif kind == "conv2d":
            k = get(params, f"{base}/kernel")  # [kh, kw, in, out]
            sd[f"{ref}.weight"] = np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))
            sd[f"{ref}.bias"] = get(params, f"{base}/bias")
        elif kind == "bev_kernel":
            sd[f"{ref}.kernel"] = get(params, f"{base}/kernel")
        else:  # pragma: no cover
            raise AssertionError(kind)

    for module, table in _HEAD_SITES.items():
        if module not in params:
            continue
        for site, (kind, flax_name) in table.items():
            emit(kind, f"{module}." + ".".join(site), f"{module}/{flax_name}")

    for module in ("attribute", "scene"):
        if module not in params or "net" not in params[module]:
            continue
        for site, (block, leaf) in _ENCODER_SITES.items():
            ref = f"{module}.net." + ".".join(site)
            base = f"{module}/net/{block}/{leaf}"
            if leaf.startswith("conv"):
                kernel = get(params, f"{base}/kernel")
                sd[f"{ref}.kernel"] = kernel[np.argsort(_perm(kernel))]
            else:
                emit("batchnorm", ref, base)

    if "lang" in params and "gru" in params["lang"]:
        for layer in (0, 1):
            for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
                g = params["lang"]["gru"].get(f"l{layer}_{direction}")
                if g is None:
                    continue
                for name, leaf in (("weight_ih", "wx"), ("weight_hh", "wh")):
                    sd[f"lang.gru.{name}_l{layer}{sfx}"] = np.ascontiguousarray(
                        np.asarray(g[leaf]).T)
                sd[f"lang.gru.bias_ih_l{layer}{sfx}"] = np.asarray(g["bx"])
                sd[f"lang.gru.bias_hh_l{layer}{sfx}"] = np.asarray(g["bh"])
    return sd


def is_sparse_kernel(key: str) -> bool:
    """A sparse-conv kernel of an encoder (the BEV kernel is not one)."""
    return key.endswith(".kernel") and ".net." in key


def _perm(value) -> np.ndarray:
    """Reference (torchsparse) offset index of each host-map offset."""
    return _PERM3 if value.shape[0] == 27 else _PERM2


def from_reference(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference-layout state_dict (tensors or numpy) -> the port's layout."""
    out = {}
    for key, value in sd.items():
        value = value.detach().cpu() if torch.is_tensor(value) else torch.from_numpy(np.array(value))
        if is_sparse_kernel(key):
            value = value[torch.from_numpy(_perm(value))]
        out[key] = value.clone()  # a writable copy, never a view of the input
    return out


def to_reference(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's layout -> the reference's, on the CPU."""
    out = {}
    for key, value in sd.items():
        value = value.detach().cpu()
        if is_sparse_kernel(key):
            value = value[torch.from_numpy(np.argsort(_perm(value)))]
        out[key] = value.clone()
    return out


def to_reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the reference's layout (CPU tensors)."""
    return to_reference(model.state_dict())


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping):
    """Load a reference-layout state_dict (from ``torch.load`` of a ``.pth``,
    or ``export_state_dict``) into the port's ``model``."""
    return model.load_state_dict(from_reference(sd))


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """flax ``(params, batch_stats)`` as numpy trees -> port state_dict."""
    return from_reference(export_state_dict(params, batch_stats))


def enet_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``Enet``'s ``{"params", "batch_stats"}`` (numpy trees) ->
    the reference's ENet state_dict, which ``models/enet.Enet`` loads
    strictly: the inverse of ``scripts/convert_enet.convert_state_dict``
    (conv HWIO -> OIHW; BatchNorm scale/bias and mean/var -> weight/bias
    and running statistics; PReLU alpha -> weight)."""
    enc = variables["params"]["encoder"]
    stats = variables["batch_stats"]["encoder"]
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(value, np.float32)))

    def conv(key, p):
        put(f"{key}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            put(f"{key}.bias", p["bias"])

    def bn(key, p, s):
        for name, value in (("weight", p["scale"]), ("bias", p["bias"]),
                            ("running_mean", s["mean"]), ("running_var", s["var"])):
            put(f"{key}.{name}", value)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def prelu(key, p):
        put(f"{key}.weight", p["alpha"])

    conv("0.0", enc["initial"]["conv"])
    bn("2", enc["initial"]["bn"], stats["initial"]["bn"])
    prelu("3", enc["initial"]["prelu"])
    for j, (name, kw) in enumerate(BOTTLENECK_PLAN):
        idx = FIRST_BOTTLENECK_INDEX + j
        ext, p, s = f"{idx}.0.0", enc[name], stats[name]
        conv(f"{ext}.0", p["conv_reduce"])
        bn(f"{ext}.1", p["bn_reduce"], s["bn_reduce"])
        prelu(f"{ext}.2", p["prelu_reduce"])
        if kw.get("asymmetric"):
            conv(f"{ext}.3", p["conv_mid_a"])
            conv(f"{ext}.4", p["conv_mid_b"])
            mid = 5
        else:
            conv(f"{ext}.3", p["conv_mid"])
            mid = 4
        bn(f"{ext}.{mid}", p["bn_mid"], s["bn_mid"])
        prelu(f"{ext}.{mid + 1}", p["prelu_mid"])
        conv(f"{ext}.{mid + 2}", p["conv_expand"])
        bn(f"{ext}.{mid + 3}", p["bn_expand"], s["bn_expand"])
        prelu(f"{idx}.2", p["prelu_out"])
    conv(f"{FIRST_BOTTLENECK_INDEX + len(BOTTLENECK_PLAN)}.0",
         variables["params"]["classifier"]["conv"])
    return sd


def load_enet(path: str) -> Enet:
    """An ``Enet`` with the weights of the reference state_dict at ``path``
    (``scannetv2_enet.pth``), loaded strictly; eval mode, on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = Enet()
    model.load_state_dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)
    return model.eval()
