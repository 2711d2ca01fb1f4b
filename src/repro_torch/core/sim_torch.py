"""The grid DES on the card: the counterpart of ``repro.core.sim_jax``.

The host engines (``core.sim_fast``) are fastest for one cell; this module
runs the embarrassingly parallel axis of a sweep on the device.  Every
(policy, tau, rho, seed) cell is an independent serial-server simulation,
so all G cells advance together as (G, n) tensors, one masked step per
dispatch, ``n`` steps in all (each cell dispatches exactly ``n``
requests).  A step is the work of ``sim_jax._simulate_one`` for every row
at once: the next arrival among the undone requests, the admission mask,
the FIFO-oldest promotion test against tau (NaN: never), the (key, index)
argmin, and the scatter of start, done and promoted.  The loop reads
nothing back to the host until it ends.

Requests must be sorted by ``(arrival, req_id)`` per row, as for the host
engines.  In ``torch.float64`` start and finish equal the host engines'
bit for bit (the counterpart of JAX's x64 mode); in ``torch.float32``
(JAX's default mode) the dispatch order matches wherever the float32
clock cannot flip a comparison, and times agree to float32 tolerance.

Only key-based policies run here; ``core.sweep`` routes preemptive rows
(srpt / mlfq) to the host preemptive engine.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import resolve_device


def _first(mask: torch.Tensor) -> torch.Tensor:
    """(G,) index of the first True of each row (0 for an all-False row):
    ``argmax`` returns the first maximal index, and takes no bool on
    CUDA, hence the uint8 cast."""
    return mask.to(torch.uint8).argmax(dim=1)


@torch.no_grad()
def simulate_grid_torch(arrival, service, key, tau, *, device=None,
                        dtype=torch.float64):
    """G independent simulations on ``device`` (the card unless given).

    Same contract as :func:`sim_fast.simulate_grid`: (G, n) arrays sorted
    by arrival per row, ``tau`` a length-G sequence with None disabling
    the guard.  Returns numpy ``(start, finish, promoted, promotions)``.
    """
    dev = resolve_device(device)
    arr = torch.as_tensor(np.asarray(arrival, np.float64), device=dev) \
        .to(dtype)
    svc = torch.as_tensor(np.asarray(service, np.float64), device=dev) \
        .to(dtype)
    k = torch.as_tensor(np.asarray(key, np.float64), device=dev).to(dtype)
    tau_t = torch.tensor([np.nan if t is None else float(t) for t in tau],
                         dtype=torch.float64, device=dev).to(dtype)
    G, n = arr.shape
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    t = torch.zeros(G, dtype=dtype, device=dev)
    done = torch.zeros((G, n), dtype=torch.bool, device=dev)
    start = torch.zeros((G, n), dtype=dtype, device=dev)
    promoted = torch.zeros((G, n), dtype=torch.bool, device=dev)
    promos = torch.zeros(G, dtype=torch.int64, device=dev)
    for _ in range(n):
        next_arr = torch.where(done, inf, arr).amin(dim=1)
        queued = (arr <= t[:, None]) & ~done
        t = torch.where(queued.any(dim=1), t, torch.maximum(t, next_arr))
        queued = (arr <= t[:, None]) & ~done
        oldest = _first(queued)                  # first queued = FIFO head
        head_arr = arr.gather(1, oldest[:, None])[:, 0]
        promote = (t - head_arr) > tau_t         # NaN tau: always False
        masked = torch.where(queued, k, inf)
        pick = _first(queued & (masked == masked.amin(dim=1, keepdim=True)))
        j = torch.where(promote, oldest, pick)[:, None]
        start.scatter_(1, j, t[:, None])
        t = t + svc.gather(1, j)[:, 0]
        done.scatter_(1, j, True)
        promoted.scatter_(1, j, promote[:, None])
        promos += promote
    finish = start + svc
    return (start.cpu().numpy().astype(np.float64),
            finish.cpu().numpy().astype(np.float64),
            promoted.cpu().numpy(), promos.cpu().numpy())
