"""The stage-1 contrast memory bank (`--use_memory_bank`). Port of
`pose3d_tpu/losses/memory_bank.py`.

An extension beyond the reference, whose NCE is in-batch only: a
MoCo-style FIFO queue of past teacher features enlarges the symmetric
NCE's negative pool. The queue, its write position and its fill count are
tensors on the features' device, so a step reads and advances them with no
host sync:

    bank = init_memory_bank(4096, 200, device)
    loss = info_nce_memory(student_feat, teacher_feat, bank, tau, keep=keep)
    bank = enqueue(bank, teacher_feat, valid)   # after the step
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pose3d_tpu_torch.losses.nce import _l2_normalize, _weighted_nce


class MemoryBank(NamedTuple):
    queue: torch.Tensor   # (K, D), L2-normalised entries
    ptr: torch.Tensor     # () int64, the next write position
    filled: torch.Tensor  # () int64, the entries written so far (at most K)


def init_memory_bank(size: int, dim: int, device=None) -> MemoryBank:
    """An empty f32 queue of `size` entries of width `dim` on `device`."""
    return MemoryBank(queue=torch.zeros((size, dim), device=device),
                      ptr=torch.zeros((), dtype=torch.int64, device=device),
                      filled=torch.zeros((), dtype=torch.int64, device=device))


def enqueue(bank: MemoryBank, features: torch.Tensor,
            valid: torch.Tensor | None = None) -> MemoryBank:
    """The bank with the (normalised, detached) rows of `features` written
    from `ptr` on, wrapping modulo K. With `valid` ((N,) bool) only the
    valid rows are written, compacted to consecutive slots by a cumsum, and
    ptr and filled advance by the valid count, as JAX's masked scatter
    does. Returns a new bank; the given one is left as it was."""
    feats = _l2_normalize(features.detach().to(bank.queue.dtype))
    k, b = bank.queue.shape[0], feats.shape[0]
    if valid is None:
        idx = (bank.ptr + torch.arange(b, device=feats.device)) % k
        n_written = torch.full((), b, dtype=torch.int64, device=feats.device)
    else:
        v = valid.to(torch.int64)
        # invalid rows go to slot k, one past the queue, which is dropped
        idx = torch.where(v > 0, (bank.ptr + torch.cumsum(v, 0) - 1) % k,
                          torch.full_like(v, k))
        n_written = v.sum()
    queue = torch.cat([bank.queue, bank.queue.new_zeros((1, bank.queue.shape[1]))])
    queue = queue.index_copy(0, idx, feats)[:k]
    return MemoryBank(queue=queue, ptr=(bank.ptr + n_written) % k,
                      filled=torch.clamp(bank.filled + n_written, max=k))


def info_nce_memory(feat_student: torch.Tensor, feat_teacher: torch.Tensor,
                    bank: MemoryBank, tau: float = 0.1, valid: torch.Tensor | None = None,
                    keep: torch.Tensor | None = None,
                    dropout_rate: float = 0.3) -> torch.Tensor:
    """infoNCE-KD with the negative pool extended by the queue:
    denom_i = e^pos_i + sum_j e^{<s_i, t_j>/tau} + sum_q e^{<s_i, q>/tau},
    unfilled queue slots masked to -inf. `valid` (N,) bool masks padded
    rows out of the in-batch keys and the mean. `keep` ((N, D) bool) is
    the key-side dropout's keep-mask (JAX draws it from `dropout_rng`);
    None for no dropout. The queue's entries are compared without dropout."""
    if keep is not None and dropout_rate > 0.0:
        feat_teacher = torch.where(keep, feat_teacher / (1.0 - dropout_rate),
                                   torch.zeros_like(feat_teacher))
    s, t = _l2_normalize(feat_student), _l2_normalize(feat_teacher)
    pos = torch.sum(s * t, dim=-1) / tau
    neg_batch = (s @ t.T) / tau
    if valid is not None:
        neg_batch = neg_batch.masked_fill(~valid[None, :], float("-inf"))
    neg_queue = (s @ bank.queue.to(s.dtype).T) / tau
    k = bank.queue.shape[0]
    unfilled = (torch.arange(k, device=s.device) >= bank.filled)[None, :]
    neg_queue = neg_queue.masked_fill(unfilled, float("-inf"))
    return _weighted_nce(pos, torch.cat([neg_batch, neg_queue], dim=-1), None, valid)
