"""K3: the dense candidate pass over a V x V gram."""


def pairwise_flops(vocab_size: int, d1: int) -> int:
    """The upper triangle's V(V-1)/2 dot products of d1 multiply-adds."""
    return vocab_size * (vocab_size - 1) // 2 * d1 * 2
