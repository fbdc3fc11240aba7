"""Bipartite matching on the device: Bertsekas' auction algorithm, the
PyTorch port of fastervit_tpu/detection/matcher_device.py (:33-104).

The reference's Hungarian matcher runs scipy on the host every train step
(dino/models/dino/matcher.py:80-104; here `engine.solve_assignments`),
which costs a device-to-host sync a step. The auction runs on the cost
matrices where they lie: a parallel (Jacobi) forward auction, every
(layer, image) problem of a step at once as one (P, Q, T) tensor, in a
Python loop of tensor ops (the JAX package's `lax.while_loop`, vmapped
over images and stacked over layers).

Guarantee (Bertsekas 1988): with bid increment eps, the assignment's total
cost is within n_targets·eps of the optimum. Each round is JAX's round op
for op in f32, and torch.argmax, like jnp.argmax, takes the first maximum,
so the assignments are JAX's. A round in which no valid target is
unassigned changes nothing, so the loop asks the device whether it is done
only every _CHECK_EVERY rounds (one sync each) and stays exact; it stops
after max_iters rounds, as JAX's loop does, leaving any target still
unassigned at -1.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_NEG = -1e30
_CHECK_EVERY = 8   # rounds between the loop's checks for termination


def _auction(cost: torch.Tensor, valid: torch.Tensor, eps: float,
             max_iters: int) -> torch.Tensor:
    """cost (P, Q, T), valid (P, T) bool -> (P, T) int64 assignments."""
    p, q, t = cost.shape
    dev = cost.device
    benefit = torch.where(valid[:, None, :], -cost.float(),
                          torch.tensor(_NEG, device=dev))
    price = torch.zeros((p, q), dtype=torch.float32, device=dev)
    assign = torch.full((p, t), -1, dtype=torch.long, device=dev)
    tids = torch.arange(t, device=dev)[None]
    qids = torch.arange(q, device=dev)[None, :, None]
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    for it in range(max_iters):
        unassigned = (assign < 0) & valid
        if it % _CHECK_EVERY == 0 and not bool(unassigned.any()):
            break
        value = benefit - price[:, :, None]                     # (P, Q, T)
        j1 = value.argmax(1)                                    # (P, T)
        chosen = qids == j1[:, None, :]
        v2 = torch.where(chosen, neg, value).amax(1)
        # bid for target t on query j1[t]: benefit - v2 + eps
        bid = benefit.gather(1, j1[:, None, :])[:, 0] - v2 + eps
        bid = torch.where(unassigned, bid, neg)
        # each query's best bidder this round
        score = torch.where(chosen, bid[:, None, :], neg)       # (P, Q, T)
        winner = score.argmax(2)                                # (P, Q)
        wbid = score.amax(2)
        has = wbid > _NEG / 2
        price = torch.where(has, wbid, price)
        # the previous owners of re-priced queries are evicted
        cur = assign.clamp(0, q - 1)
        evicted = ((assign >= 0) & has.gather(1, cur)
                   & (winner.gather(1, cur) != tids))
        assign = torch.where(evicted, -1, assign)
        # each target bids on one query, so it wins iff it is the best
        # bidder there
        won = unassigned & has.gather(1, j1) & (winner.gather(1, j1) == tids)
        assign = torch.where(won, j1, assign)
    return torch.where(valid, assign, -1)


def auction_match(cost: torch.Tensor, valid: torch.Tensor,
                  eps: float = 1e-3, max_iters: int = 20000) -> torch.Tensor:
    """cost (..., Q, T) float; valid (..., T) bool. Returns (..., T) int64:
    the query assigned to each valid target (distinct across targets) and
    -1 for an invalid one, the total cost within Σvalid·eps of the optimum
    (matcher_device.py::auction_match, batched over the leading
    dimensions)."""
    lead = cost.shape[:-2]
    q, t = cost.shape[-2:]
    out = _auction(cost.reshape(-1, q, t), valid.reshape(-1, t).bool(), eps,
                   max_iters)
    return out.reshape(*lead, t)


def solve_assignments_device(costs: Sequence[torch.Tensor],
                             tgt_mask: torch.Tensor,
                             eps: float = 1e-3) -> torch.Tensor:
    """engine.solve_assignments on the device: L costs (B, Q_l, T) and the
    (B, T) target mask -> (L, B, T) int64, the query of each target and -1
    for an invalid one. Layers of one Q are solved together, in one
    auction."""
    out = [None] * len(costs)
    groups = {}
    for li, c in enumerate(costs):
        groups.setdefault(tuple(c.shape), []).append(li)
    for layers in groups.values():
        stacked = torch.stack([costs[li] for li in layers])
        mask = tgt_mask.bool()[None].expand(len(layers), -1, -1)
        got = auction_match(stacked, mask, eps)
        for k, li in enumerate(layers):
            out[li] = got[k]
    return torch.stack(out)


def assignment_cost(cost, assign) -> float:
    """Total matched cost of a (T,) assignment on a (Q, T) matrix."""
    cost, assign = np.asarray(cost), np.asarray(assign)
    return sum(float(cost[qi, ti]) for ti, qi in enumerate(assign) if qi >= 0)
