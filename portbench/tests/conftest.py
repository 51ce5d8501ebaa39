"""Shared fixtures of the benchmark's tests: a small flagship and a small
pretraining that the CPU runs in seconds, and the card, decided inside a
fixture."""

import pytest
import torch

# Keys of the cell's configuration, cell and traffic files replaced.
SMALL_FLAGSHIP = {
    "config": dict(max_vocab_size=1024, steps=700, log_every=128,
                   target_vocab_size=900, corpus_max_tokens=12000,
                   optimize_curvature_freq=100),
    "cell": dict(warmup_merges=128),
    "traffic": dict(max_lines=40)}
SMALL_PRETRAIN = {
    "config": dict(embed_steps=40, embed_corpus_tokens=20000),
    "cell": dict(warmup_steps=3),
    "traffic": dict(max_lines=200)}


def smaller(small: dict, **config) -> dict:
    """``small`` with more keys of the configuration replaced."""
    return dict(small, config=dict(small["config"], **config))


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
