"""K4: one chunk of the distance-only loop."""


def chunk_bytes(vocab0: int, n_merges: int, d1: int, max_v: int,
                max_token_len: int = 0) -> int:
    """The active rows' coordinates; ``best_dist`` over all ``max_v``
    slots and ``best_j`` over the final prefix, read and written back; the
    lengths of the active rows with the length gate, else of the merged
    pairs' rows; the new rows, their lengths and the history written."""
    v1 = vocab0 + n_merges
    lengths = vocab0 if max_token_len > 0 else min(vocab0, 2 * n_merges)
    return (vocab0 * d1 * 4 + max_v * 4 + v1 * 4 + v1 * 8 + lengths * 4
            + n_merges * (d1 * 4 + 4 + 8 + 4))


def chunk_ops(vocab0: int, n_merges: int, n_steps: int, d1: int) -> int:
    """The k-th merge's fold over its vocab0 + k rows (a d1-long dot and an
    acosh, 8) and every step's argmin over the vocab0 active entries."""
    rows = n_merges * vocab0 + n_merges * (n_merges - 1) // 2
    return rows * (2 * d1 + 8) + n_steps * vocab0
