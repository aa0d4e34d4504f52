"""Shape buckets for batched serving (counterpart of
`paddle_tpu/inference.py`; only `default_buckets` and `next_bucket`)."""

__all__ = ["default_buckets", "next_bucket"]


def default_buckets(max_batch_size):
    """Power-of-two batch buckets up to (and including) max_batch_size:
    64 -> (1, 2, 4, 8, 16, 32, 64)."""
    max_batch_size = int(max_batch_size)
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


def next_bucket(n, buckets):
    """Smallest bucket >= n, or raise when n exceeds every bucket."""
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    raise ValueError(
        f"batch of {n} rows exceeds the largest bucket {max(buckets)}")
