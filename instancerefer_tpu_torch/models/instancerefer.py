"""Top-level InstanceRefer, counterpart of
``instancerefer_tpu/models/instancerefer.py``: lang -> attribute -> relation
-> scene over one data dict.  Train or eval mode follows ``nn.Module.train()``
(the JAX package's ``train=`` argument); the BN momentum of train mode is
set with ``set_bn_momentum`` (its ``bn_momentum=`` argument).

``build_model`` is what the CLIs call: the model of a config.  The JAX
package can switch the attribute, relation and scene modules off, but cannot
train such a model either (``get_loss`` sums all three scores), so here a
config that switches one off is refused."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from instancerefer_tpu_torch.models.attribute_module import AttributeModule
from instancerefer_tpu_torch.models.basic_blocks import (
    MaskedBatchNorm,
    SparseConv,
    ToDenseBEVConvolution,
)
from instancerefer_tpu_torch.models.lang_module import LangModule
from instancerefer_tpu_torch.models.relation_module import RelationModule
from instancerefer_tpu_torch.models.scene_module import SceneModule
from instancerefer_tpu_torch.utils.profiling import span


class InstanceRefer(nn.Module):
    def __init__(self, input_feature_dim: int, num_classes: int = 18,
                 max_candidates: int = 16, use_bidir: bool = True, k: int = 8,
                 generator: Optional[torch.Generator] = None,
                 dropout_override: Optional[float] = None):
        """``dropout_override``: None keeps each module's reference rate
        (lang word dropout 0.1, relation and scene 0.15); a float sets every
        dropout to it (0.0 for parity runs)."""
        super().__init__()
        self.lang = LangModule(num_classes, use_bidir)
        self.attribute = AttributeModule(input_feature_dim, max_candidates)
        self.relation = RelationModule(input_feature_dim, num_classes, k=k)
        self.scene = SceneModule(input_feature_dim)
        init_parameters(self, generator)
        if dropout_override is not None:
            for m in self.modules():
                if isinstance(m, nn.Dropout):
                    m.p = dropout_override

    def set_bn_momentum(self, momentum: float) -> None:
        """Momentum of every BatchNorm's running-statistics update (the
        reference's BNMomentumScheduler sets it per epoch)."""
        for m in self.modules():
            if isinstance(m, MaskedBatchNorm):
                m.momentum = momentum

    def forward(self, data_dict: dict) -> dict:
        for name in ("lang", "attribute", "relation", "scene"):
            with span(f"ir.fwd.{name}"):
                data_dict = getattr(self, name)(data_dict)
        return data_dict


MODULE_SWITCHES = ("attribute_module", "relation_module", "scene_module")


def build_model(cfg, generator: Optional[torch.Generator] = None) -> InstanceRefer:
    """The model of a ``config.Config``: input width, classes, candidates,
    ``use_bidir`` and ``k``.  Raises ``ValueError`` naming the key when one
    of ``MODULE_SWITCHES`` is off."""
    for key in MODULE_SWITCHES:
        if not getattr(cfg, key):
            raise ValueError(
                f"{key} is off ({getattr(cfg, key)!r}): the port builds and trains "
                "only the full model, whose loss sums the attribute, relation and "
                "scene scores"
            )
    return InstanceRefer(cfg.input_feature_dim, cfg.num_classes, cfg.max_candidates,
                         use_bidir=cfg.use_bidir, k=cfg.k, generator=generator)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Torch's default initialization, drawn from ``generator``: U(+-1/sqrt(fan_in))
    for linear, conv and sparse-conv weights and biases (fan_in = K * Cin for
    a sparse conv), U(+-1/sqrt(hidden)) for the GRU, ones/zeros for norms."""

    def uniform(t: torch.Tensor, fan_in: int) -> None:
        bound = 1.0 / math.sqrt(max(fan_in, 1))
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            uniform(m.weight, fan_in)
            uniform(m.bias, fan_in)
        elif isinstance(m, SparseConv):
            uniform(m.kernel, m.kernel.shape[0] * m.kernel.shape[1])
        elif isinstance(m, ToDenseBEVConvolution):
            uniform(m.kernel, m.kernel.shape[1])
        elif isinstance(m, nn.GRU):
            for p in m.parameters():
                uniform(p, m.hidden_size)
        elif isinstance(m, (nn.LayerNorm, MaskedBatchNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
