"""Global place recognition: one-matmul loop-closure proposals (port of
``vision/place.py``).

The reference only ever attempts loop closures against the last
``m_lookback_nodes`` (5-7) keyframes (``gtsam_graph.cpp:1716-1753``). This
is the JAX package's global tier:

- every keyframe's local descriptors aggregate into ONE global descriptor
  (VLAD with a fixed pseudo-random codebook on the unit sphere: hard
  assignment, residual aggregation, signed-sqrt and intra-normalization —
  two matmuls over all features);
- the keyframe bank is a padded (capacity, Dg) device matrix that doubles
  when full; querying a new frame against every banked place is one
  matvec + top-k (a stable sort: ties to the lower id, as XLA's ``top_k``).

The codebook is drawn with numpy's ``default_rng`` exactly as the
reference draws it, so it is bit-equal. Proposals feed the pairwise
matcher and its gates; geometry still decides.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_host, upload
from .features import FeatureFrame, topk_stable

__all__ = ["PlaceIndex", "global_descriptor"]

_codebook_cache: dict = {}


def _codebook(desc_dim: int, n_centers: int, seed: int) -> np.ndarray:
    """(n_centers, desc_dim) float32 unit rows, the reference's draw."""
    key = (desc_dim, n_centers, seed)
    if key not in _codebook_cache:
        r = np.random.default_rng(seed)
        c = r.normal(size=(n_centers, desc_dim)).astype(np.float32)
        _codebook_cache[key] = c / np.linalg.norm(c, axis=1, keepdims=True)
    return _codebook_cache[key]


def global_descriptor(frame: FeatureFrame, n_centers: int = 16,
                      seed: int = 0):
    """Aggregate a frame's local descriptors into one (n_centers * D,)
    L2-normalized global descriptor on the frame's device (VLAD with a
    fixed random codebook: hard nearest-center assignment, residual
    aggregation, signed-sqrt power normalization, intra + global L2).

    Soft assignment is useless here: random unit centers give cosine sims
    ~N(0, 1/sqrt(D)), so every frame would collapse to the same
    descriptor (the reference measured 0.99 cross-scene similarity)."""
    d = frame.desc.to(torch.float32)
    centers = upload(_codebook(d.shape[1], n_centers, seed), d.device)
    w = frame.valid.to(torch.float32)
    sim = d @ centers.T                                   # (M, C)
    a = torch.nn.functional.one_hot(torch.argmax(sim, dim=1),
                                    n_centers).to(d.dtype) * w[:, None]
    # residual aggregation: V[c] = sum_{i -> c} (d_i - center_c)
    V = a.T @ d - (torch.sum(a, dim=0)[:, None] * centers)   # (C, D)
    V = torch.sign(V) * torch.sqrt(torch.abs(V))
    V = V / torch.clamp(torch.linalg.norm(V, dim=1, keepdim=True), min=1e-8)
    v = V.reshape(-1)
    return v / torch.clamp(torch.linalg.norm(v), min=1e-8)


class PlaceIndex:
    """Append-only bank of global descriptors with top-k cosine queries.

    The bank is a padded matrix on the frames' device; ``add`` writes a
    row without reading anything back and ``query`` is one matvec with
    one read-back of its top-k.
    """

    def __init__(self, n_centers: int = 16, seed: int = 0,
                 capacity: int = 256):
        self.n_centers = n_centers
        self.seed = seed
        self._n = 0
        self._bank = None          # (cap, Dg) tensor
        self._cap = capacity

    def __len__(self) -> int:
        return self._n

    def describe(self, frame: FeatureFrame):
        return global_descriptor(frame, n_centers=self.n_centers,
                                 seed=self.seed)

    def add(self, frame: FeatureFrame) -> int:
        """Describe + append; returns the new row id."""
        g = self.describe(frame)
        n = self._n + 1
        if self._bank is None or n > self._bank.shape[0]:
            while self._cap < n:
                self._cap *= 2
            bank = torch.zeros((self._cap, g.shape[0]), dtype=g.dtype,
                               device=g.device)
            if self._bank is not None:
                bank[:self._n] = self._bank[:self._n]
            self._bank = bank
        self._bank[n - 1] = g
        self._n = n
        return n - 1

    def query(self, frame: FeatureFrame, top_k: int = 3,
              max_id: int | None = None):
        """(ids, sims) numpy of the most similar banked places, best
        first.

        ``max_id``: only consider rows with id < max_id (exclude recent
        keyframes so proposals don't duplicate the lookback window).
        """
        n = self._n if max_id is None else min(max_id, self._n)
        if n <= 0 or self._bank is None:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        g = self.describe(frame)
        sims = self._bank @ g                               # (cap,)
        mask = torch.arange(self._bank.shape[0], device=sims.device) < n
        sims = torch.where(mask, sims, torch.full_like(sims, -torch.inf))
        top, idx = to_host(topk_stable(sims, min(top_k, n)))
        keep = np.isfinite(top)
        return idx[keep], top[keep]
