"""Service-time models (a copy of ``repro.serving.service_time``, with the
card's peaks in ``from_arch``).

``ServiceTimeModel.service`` is the admission layer's estimate of a
request's service seconds: the key of the ``sjf_oracle`` policy, the
virtual-time engines' clock (``SimEngine``, ``SimTextBackend``, the DES)
and the base of the starvation-guard calibration.  Two calibrations:

* ``from_arch`` -- roofline arithmetic from an architecture's shapes:
  prefill is compute-bound (2 * N_active FLOPs a token at ``mfu`` of the
  card's dense bf16 peak), decode memory-bound (the active weights plus
  the KV cache streamed once a token, at ``hbm_frac`` of the card's HBM
  rate).  The peaks are the NVIDIA H100 SXM5 data sheet's
  (``H100_SXM_PEAKS``), not a measurement.
* ``PAPER_*`` -- the paper's measured distributions (Table 1 M1 service
  stats; §5.5 RTX 4090 N(3.5,0.8)/N(8.9,2.0)), for faithful replication of
  its queueing results.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.simulation import ServiceDist

#: NVIDIA H100 80GB HBM3 (SXM5) data-sheet peaks at its full 700 W power
#: limit: dense bf16 tensor-core FLOP/s and HBM3 bytes/s.  A card set
#: below 700 W runs slower under load.
H100_SXM_PEAKS = {"name": "NVIDIA H100 80GB HBM3 (SXM5), 700 W",
                  "bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def expected_speedup(accept_rate, draft_k: int, draft_cost: float = 0.15):
    """Expected decode speedup of draft-verify speculation.

    With per-position acceptance rate ``a`` and draft depth ``k``, one
    round emits ``E = (1 - a^(k+1)) / (1 - a)`` target tokens (the
    accepted prefix plus the bonus token) and costs ``k`` draft forwards
    plus one verify forward, so the speedup over serial decode is
    ``E / (k * draft_cost + 1)`` where ``draft_cost`` is the draft/target
    per-forward cost ratio.  Can be < 1 at low acceptance — speculation
    is not free.  Accepts scalars or arrays; ``draft_k == 0`` is exactly
    1.0 (no speculation).
    """
    if draft_k == 0:
        a = np.asarray(accept_rate, np.float64)
        return np.ones_like(a) if a.ndim else 1.0
    a = np.clip(np.asarray(accept_rate, np.float64), 0.0, 1.0 - 1e-9)
    tokens_per_round = (1.0 - a ** (draft_k + 1)) / (1.0 - a)
    out = tokens_per_round / (draft_k * draft_cost + 1.0)
    return out if out.ndim else float(out)


@dataclass
class ServiceTimeModel:
    """service(prompt_tokens, output_tokens) in seconds.

    ``effective_rate`` is the speculative-decoding seam: a multiplier on
    the decode rate (``expected_speedup(accept_rate, k)`` when a draft
    lane is live, 1.0 otherwise).  The default of 1.0 is an IEEE-exact
    identity -- ``x * 1.0 == x`` -- so a model without speculation is
    bitwise unchanged by it.
    """
    prefill_tok_per_s: float
    decode_tok_per_s: float
    overhead_s: float = 0.010
    effective_rate: float = 1.0

    def service(self, prompt_tokens: int, output_tokens: int) -> float:
        return (self.overhead_s
                + prompt_tokens / self.prefill_tok_per_s
                + output_tokens
                / (self.decode_tok_per_s * self.effective_rate))

    def service_batch(self, prompt_tokens, output_tokens) -> np.ndarray:
        """Vectorized ``service`` over whole request batches (float64) --
        what the SoA simulation path (core.sim_fast) consumes."""
        return (self.overhead_s
                + np.asarray(prompt_tokens, np.float64)
                / self.prefill_tok_per_s
                + np.asarray(output_tokens, np.float64)
                / (self.decode_tok_per_s * self.effective_rate))

    @classmethod
    def from_arch(cls, cfg, chips: int = 1, mfu: float = 0.4,
                  hbm_frac: float = 0.7, kv_tokens: int = 2048
                  ) -> "ServiceTimeModel":
        """Roofline rates of ``cfg`` on ``chips`` H100s at their data-sheet
        peaks (arithmetic: for gemma3-4b-edge on one card about 51k
        prefill and 290 decode tokens a second)."""
        peaks = H100_SXM_PEAKS
        n_active = cfg.active_param_count()
        prefill = chips * peaks["bf16_flops"] * mfu / (2.0 * n_active)
        kv_bytes_per_tok = (2 * cfg.kv_dim * 2
                            * sum(k.startswith("attn") for k in cfg.block_pattern)
                            * cfg.pattern_repeats)
        bytes_per_decode = 2.0 * n_active + kv_bytes_per_tok * kv_tokens
        decode = chips * peaks["hbm_bytes_per_s"] * hbm_frac \
            / bytes_per_decode
        return cls(prefill_tok_per_s=prefill, decode_tok_per_s=decode)


# --- the paper's measured calibrations -------------------------------------

# RTX 4090 + Gemma3:4b steady-state DES calibration (§5.5)
PAPER_4090_SHORT = ServiceDist(mean=3.5, std=0.8)
PAPER_4090_LONG = ServiceDist(mean=8.9, std=2.0)

# Apple M1 + Gemma3:4b sequential service times (Table 1)
PAPER_M1_SHORT = ServiceDist(mean=2.1, std=1.1)
PAPER_M1_LONG = ServiceDist(mean=29.7, std=11.7)


# per-class response-length draws: (lognormal mu, sigma, clip lo, clip hi);
# medium is a uniform integer range instead
_LEN_SHORT = (3.7, 0.8, 1, 199)
_LEN_LONG = (float(np.log(1400.0)), 0.45, 800, 8000)
_LEN_MEDIUM = (200, 800)


def sample_output_tokens(rng, klass: str) -> int:
    """Response-length draw consistent with the corpus class boundaries."""
    if klass == "medium":
        return int(rng.integers(*_LEN_MEDIUM))
    mu, sig, lo, hi = _LEN_SHORT if klass == "short" else _LEN_LONG
    return int(np.clip(rng.lognormal(mu, sig), lo, hi))


def sample_output_tokens_batch(rng, klasses) -> np.ndarray:
    """Vectorized :func:`sample_output_tokens` over an array of class
    names (or ``sim_fast.KLASSES`` codes) -- one draw pass per class."""
    klasses = np.asarray(klasses)
    if klasses.dtype.kind in "US":
        from repro_torch.core.sim_fast import KLASSES
        code = {k: i for i, k in enumerate(KLASSES)}
        klasses = np.array([code[k] for k in klasses], np.int8)
    n = klasses.shape[0]
    out = np.empty(n, np.int64)
    short = klasses == 1
    med = klasses == 2
    long = ~(short | med)
    for mask, (mu, sig, lo, hi) in ((short, _LEN_SHORT), (long, _LEN_LONG)):
        out[mask] = np.clip(rng.lognormal(mu, sig, int(mask.sum())),
                            lo, hi).astype(np.int64)
    out[med] = rng.integers(*_LEN_MEDIUM, size=int(med.sum()))
    return out
