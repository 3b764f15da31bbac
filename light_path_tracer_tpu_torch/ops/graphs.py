"""Blocks of loop steps replayed as CUDA graphs: the launch path of the
plain PyTorch loops that have no kernel.

The fixed-step RK4 tracer, the 8-D path recorder and the adaptive loop
of a metric without a kernel (`CustomMetric`) are plain PyTorch on the
card, as their JAX counterparts are XLA there; the adaptive loop is also
every kernel's plain version on a CUDA tensor. Each of their steps is
hundreds of small elementwise launches, so on the card they are bound by
the host's dispatch, not by the device. `step_blocks` runs such a loop
in blocks of steps between the host's questions whether to go on: on a
CUDA device the first block runs eagerly (it warms every kernel up) and
each later full block replays a CUDA graph captured from one block, so
the host issues one replay a block instead of every launch. The graph
holds the same kernels with the same arguments, so a block's result is
bitwise the eager one; on the CPU every block runs eagerly.
"""

from __future__ import annotations

import torch


def _eager_block(step, carry, n):
    """n steps eagerly: (carry, per-step records stacked on a new axis
    0, one tensor a record)."""
    recs = []
    for _ in range(n):
        carry, rec = step(carry)
        recs.append(rec)
    return carry, tuple(torch.stack(r) for r in zip(*recs))


class _Graph:
    """One block of `n` steps captured on static copies of the carry; a
    replay advances the static carry in place and leaves the block's
    records in `recs`."""

    def __init__(self, step, carry, n):
        self.carry = tuple(c.clone() for c in carry)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out, self.recs = _eager_block(step, self.carry, n)
            for s, c in zip(self.carry, out):
                s.copy_(c)

    def replay(self, carry):
        if carry is not self.carry:
            for s, c in zip(self.carry, carry):
                s.copy_(c)
        self.graph.replay()
        return self.carry, self.recs


def step_blocks(step, carry, n_steps, keep_going, sink=None, block=8,
                graph=True):
    """Apply `carry, rec = step(carry)` up to n_steps times.

    carry: a tuple of tensors, returned by step with the same shapes and
    dtypes; rec: a tuple of tensors recorded each step (may be empty).
    keep_going(carry) -> bool is asked before every block of `block`
    steps (a host sync); the loop stops where it says False.
    sink(i0, recs), if given, receives after each block the records of
    steps i0, i0 + 1, ... stacked on axis 0 (read them before the next
    block: a replayed graph writes the same tensors). The step must not
    synchronise with the host. graph=False runs every block eagerly.
    Returns (carry, the steps made).
    """
    use_graph, captured = graph, None
    i = 0
    while i < n_steps and keep_going(carry):
        n = min(block, n_steps - i)
        if (use_graph and captured is None and n == block and i >= block
                and carry[0].device.type == "cuda"):
            captured = _Graph(step, carry, block)
        if captured is not None and n == block:
            carry, recs = captured.replay(carry)
        else:
            carry, recs = _eager_block(step, carry, n)
        if sink is not None:
            sink(i, recs)
        i += n
    return carry, i
