"""K1 (corpus-only) and K2 (dense channel): one merge segment."""

MAX_HASH_LEN = 4096   # the hash power table's length


def segment_bytes(queue_size: int, d1: int, n_merges: int,
                  dense_rows: int = 0) -> int:
    """Bytes a segment of ``n_merges`` merges must move: the three phase
    queues read and their scores written back, the token features of two
    rows read per merge (and, without the dense channel, their
    coordinates), the new row, features and history written; with the dense
    channel (``dense_rows`` active rows at the start) those rows'
    coordinates and lengths read once and ``best_dist``/``best_j`` over the
    final prefix read and written once."""
    k3 = 3 * queue_size
    queues = k3 * (4 + 4 + 4 + 4) + k3 * 4
    features = 4 + 4 + 8 + 1
    per_merge_in = 2 * (features + (0 if dense_rows else d1 * 4))
    per_merge_out = d1 * 4 + features + 8 + 4
    powers = 2 * MAX_HASH_LEN * 4
    dense = 0
    if dense_rows:
        v1 = dense_rows + n_merges
        dense = dense_rows * (d1 * 4 + 4) + v1 * 2 * (4 + 4)
    return (queues + powers + n_merges * (per_merge_in + per_merge_out)
            + dense)


def segment_ops(queue_size: int, d1: int, n_merges: int, n_steps: int,
                dense_rows: int = 0) -> int:
    """Operations a segment needs: per step a compare per entry of the
    phase's queue, per merge a compare per entry of the three queues and
    about 12 FLOP per coordinate; with the dense channel every step's
    argmin over the active rows and the k-th merge's column folded into
    each of its dense_rows + k rows (a d1-long dot and an acosh, 8)."""
    k = queue_size
    ops = n_steps * k * 2 + n_merges * (3 * k + 12 * d1)
    if dense_rows:
        rows = n_merges * dense_rows + n_merges * (n_merges - 1) // 2
        ops += n_steps * dense_rows + rows * (2 * d1 + 8)
    return ops
