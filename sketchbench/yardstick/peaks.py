"""Peak device-memory bandwidth by card (NVIDIA data sheets), frozen from
the repository's chip smoke (``MEM_RATE``, ``mem_rate``, ``bound``)."""

MEM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "H200": 4.8e12}
MEM_RATE_DEFAULT = 3.35e12  # H100 SXM
F32_OPS_RATE = 67e12


def mem_rate(name: str) -> float:
    """Bytes/s of the card named ``name`` (``torch.cuda.get_device_name``)."""
    return next((r for k, r in MEM_RATE.items() if k in name), MEM_RATE_DEFAULT)


def bound_s(bytes_moved: float, ops: float, rate: float) -> float:
    """The least time the card can take: the larger of the bytes over its
    bandwidth and the f32 operations over its f32 rate."""
    return max(bytes_moved / rate, ops / F32_OPS_RATE)
