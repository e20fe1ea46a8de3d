"""The program's sparse-conv kernels as the profiler names them, by the
launch counter that counts them (the port's ``chip_smoke.LAUNCH_FIRST`` and
``LAUNCH_REST``, copied).  A launch opens with one kernel of
``LAUNCH_FIRST`` and may run kernels of ``LAUNCH_REST`` after it (K2's dW
and its split sums, K3's split sums, the list pass's second kernel).  The
traced run holds the first kernels' count against the counters
(``trace.profile``), so a kernel renamed in the program shows as a missing
reading, not as a false share."""

import re

LAUNCH_FIRST = {
    "K1": re.compile(r"gather_gemm(_tc)?_kernel<.*false>|stem_wide_conv_kernel|dx_list_tc_kernel"),
    "K2": re.compile(r"gather_gemm(_tc)?_kernel<.*true>"),
    "K3": re.compile(r"dw_partial_kernel<.*true>|stem_wide_dw_kernel|dw_list_tc_kernel"),
    "L": re.compile(r"dw_list_count_kernel"),
}
LAUNCH_REST = re.compile(r"dw_partial_kernel<.*false>|dw_group_tc_kernel|sum_partials_kernel"
                         r"|dw_list_write_kernel")


def is_sparse(name: str) -> bool:
    return bool(LAUNCH_REST.search(name)) or any(p.search(name) for p in LAUNCH_FIRST.values())
