"""serve_moe_roofline: the routed experts' grouped products in the profiled
stretch, their least time (each call's experts hit read once and its rows in
and out once at 3.35 TB/s, or its operations at 989 TFLOP/s, whichever is
longer: ``counts_nemotron_h.NemotronH.routed_least_s`` over the routing
tally's calls in the stretch) over the device time of the grouped-GEMM
kernels there (``torch._grouped_mm``'s CUTLASS kernels, named by their
``GroupProblemShape``), in %. Device time only: the host's dispatch between
the layers, which the ``model.moe`` spans' stream time holds, does not enter.
"""

GROUPED_GEMM = r"GroupProblemShape"


def read(run):
    least = run.stats.get("moe_stretch_least_s")
    got = run.devtrace.kernel(GROUPED_GEMM) if run.devtrace is not None else None
    if not least or got is None or not got[0]:
        return None
    return 100.0 * least / got[0]
