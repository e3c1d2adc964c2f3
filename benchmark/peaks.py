"""The table of peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data
sheet, dense rates without sparsity, at the full 700 W power limit.  A
roofline share or an ``mfu`` is stated against these; the run prints the
card's name and power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bf16": 989e12}


def least_seconds(nbytes: float, ops: float, datapath: str) -> float:
    """The least time a call can take: its bytes at the memory's rate or its
    operations at the datapath's, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[datapath])
