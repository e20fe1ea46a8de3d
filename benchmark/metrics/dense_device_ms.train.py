"""Device ms a train step outside the sparse-conv kernels (``_kernel_names``):
the dense layers, the losses, Adam, the copies of ``load``, from the traced
window.  Left out where the window's kernel records do not agree with the
launch counters."""

from benchmark.metrics._kernel_names import is_sparse


def read(record):
    prof = record.get("profile")
    if record["phase"] != "train" or prof is None or not prof["agrees"]:
        return None
    dense = sum(s for name, s in prof["kernel_s"].items() if not is_sparse(name))
    return 1e3 * dense / prof["steps"]
