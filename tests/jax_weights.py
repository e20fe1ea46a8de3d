"""JAX weights as the port's state_dict, for the tests that hold the port
against the JAX package."""

from instancerefer_tpu.utils.convert_torch import export_state_dict

from instancerefer_tpu_torch.utils.convert import from_reference


def state_dict_from_jax(params, batch_stats):
    """flax ``(params, batch_stats)`` as numpy trees (or a tree of the
    params' shape: gradients, Adam's moments) -> the port's state_dict: the
    JAX package's exporter (the reference's names and layouts), then the
    port's kernel permutation (``from_reference``)."""
    return from_reference(export_state_dict(params, batch_stats))
