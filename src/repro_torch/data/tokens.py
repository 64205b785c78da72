"""Synthetic LM token streams for end-to-end training runs (a copy of
`repro/data/tokens.py`: the same seed gives the same batches in both).

Deterministic Zipf-distributed token sequences with injected n-gram
structure (so the loss has learnable signal beyond unigram frequency):
each position continues a short Markov chain with probability p_copy.
Sharded per agent for the decentralized trainer.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.2,
                 markov_order: int = 2, p_follow: float = 0.7):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        self.p_follow = p_follow
        # random deterministic successor table (the learnable structure)
        table_rng = np.random.default_rng(seed + 1)
        self.successor = table_rng.integers(0, vocab_size, size=vocab_size)

    def _unigram(self, n):
        z = self.rng.zipf(self.zipf_a, size=n).astype(np.int64)
        return (z - 1) % self.vocab

    def sample(self, batch: int, seq_len: int):
        """Returns (tokens [B, S], targets [B, S]) int32."""
        toks = np.empty((batch, seq_len + 1), dtype=np.int64)
        toks[:, 0] = self._unigram(batch)
        follow = self.rng.uniform(size=(batch, seq_len)) < self.p_follow
        fresh = self._unigram(batch * seq_len).reshape(batch, seq_len)
        for t in range(seq_len):
            nxt = self.successor[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t])
        return (toks[:, :-1].astype(np.int32),
                toks[:, 1:].astype(np.int32))


def agent_batches(vocab_size: int, num_agents: int, batch_per_agent: int,
                  seq_len: int, seed: int = 0):
    """Infinite iterator of [A, B, S] token/target batches; each agent has
    its own stream (decentralized data: different seeds => non-identical
    local distributions via distinct successor tables)."""
    streams = [TokenStream(vocab_size, seed=seed * 1000 + i)
               for i in range(num_agents)]
    while True:
        toks, targs = zip(*(s.sample(batch_per_agent, seq_len)
                            for s in streams))
        yield np.stack(toks), np.stack(targs)
