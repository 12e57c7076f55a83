"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W limit). A share of them is stated with the card's power limit
beside it (``nvidia-smi --query-gpu=power.limit``)."""
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes or operations,
    whichever bounds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S)
