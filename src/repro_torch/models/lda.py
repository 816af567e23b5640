"""LDA by collapsed Gibbs sampling under staleness (paper Section 3.1),
port of ``repro/models/lda.py``.

Shared model state (the "parameters" the staleness engine transports):
  phi       [W, K]  word-topic counts
  phi_tilde [K]     corpus-wide topic counts (sum of phi over words)

Worker-local state: its static document partition (``tokens``), the
current topic assignments ``z`` and a sweep ``cursor``; this int32 state
rides in the engine's ``update_state`` and never enters the packed ring.
One engine update resamples ``batch_docs`` documents a worker by collapsed
Gibbs against the worker's stale cached counts and emits the count deltas.
Dirichlet priors alpha = beta = 0.1 (Table 1).

The update function sees all P workers at once (``counts`` with a leading
``[P]`` axis, ``tokens``/``z`` ``[P, docs_w, doc_len]``, ``cursor [P]``).
The sweep is the JAX ``lax.scan`` over a document's tokens written out as a
loop over ``doc_len``, batched over ``[P, batch_docs]``. Sampling is
Gumbel-max, as ``jax.random.categorical`` is: one Gumbel draw of the whole
``[P, batch_docs, doc_len, K]`` block a step from the generator (or the
``gumbel_noise=`` block given), then ``argmax(logits + g)`` a token. The
deltas are +-1 scatters: their fp32 sums are exact integers in any order.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    vocab: int
    num_topics: int
    alpha: float = 0.1
    beta: float = 0.1
    batch_docs: int = 8   # documents resampled per engine step (D/(10P) in paper)


def init_counts(tokens: torch.Tensor, z: torch.Tensor, cfg: LDAConfig) -> Any:
    """Global counts implied by assignments ``z`` over ALL workers' tokens."""
    phi = torch.zeros((cfg.vocab, cfg.num_topics), device=tokens.device)
    phi.index_put_((tokens.reshape(-1).long(), z.reshape(-1).long()),
                   torch.ones((), device=tokens.device), accumulate=True)
    return {"phi": phi, "phi_tilde": phi.sum(dim=0)}


def init_worker_state(tokens_w: torch.Tensor, z_w: torch.Tensor) -> Any:
    """Per-worker local state. ``tokens_w/z_w``: [docs_w, doc_len] int32."""
    return {"tokens": tokens_w, "z": z_w,
            "cursor": torch.zeros((), dtype=torch.int32,
                                  device=tokens_w.device)}


def _doc_theta(z: torch.Tensor, k: int) -> torch.Tensor:
    """Topic counts of each document: ``[..., doc_len] -> [..., K]``."""
    return F.one_hot(z.long(), k).sum(dim=-2).float()


def gumbel(shape, gen, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)``, as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=gen, device=gen.device).to(device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _gibbs_sweep(phi, phi_tilde, toks, z, g, cfg: LDAConfig):
    """Collapsed Gibbs over ``[P, n, L]`` documents against the workers'
    counts ``phi [P, W, K]``, ``phi_tilde [P, K]``, one token position at a
    time, with Gumbel noise ``g [P, n, L, K]``. The document's own
    assignments are decremented before each draw; the shared counts are the
    worker's stale cache, read-only during the sweep."""
    k = cfg.num_topics
    theta = _doc_theta(z, k)                                   # [P, n, K]
    w_beta = cfg.vocab * cfg.beta
    widx = torch.arange(phi.shape[0], device=phi.device)[:, None]
    z_new = torch.empty_like(z)
    for pos in range(z.shape[-1]):
        z_old = F.one_hot(z[..., pos].long(), k).float()       # [P, n, K]
        theta = theta - z_old
        phi_w = phi[widx, toks[..., pos].long()] - z_old
        phit = phi_tilde.unsqueeze(1) - z_old
        logits = (torch.log(torch.clamp_min(theta + cfg.alpha, 1e-10))
                  + torch.log(torch.clamp_min(phi_w + cfg.beta, 1e-10))
                  - torch.log(torch.clamp_min(phit + w_beta, 1e-10)))
        pick = torch.argmax(logits + g[..., pos, :], dim=-1)
        z_new[..., pos] = pick.to(z.dtype)
        theta = theta + F.one_hot(pick, k).float()
    return z_new


def make_update_fn(cfg: LDAConfig):
    """Engine UpdateFn: ``(counts, worker_state, batch, gen) -> (delta,
    state', metrics)`` over all P workers. ``batch`` is unused (each worker
    owns its partition; the cursor picks the next ``batch_docs``
    documents): pass any placeholder with a leading worker axis.
    ``gumbel_noise=`` replaces the step's Gumbel draw with a given ``[P,
    batch_docs, doc_len, K]`` block."""
    def update_fn(counts, wstate, batch, gen, gumbel_noise=None):
        tokens, z, cursor = wstate["tokens"], wstate["z"], wstate["cursor"]
        p, docs_w, doc_len = tokens.shape
        idx = (cursor.long()[:, None]
               + torch.arange(cfg.batch_docs, device=tokens.device)) % docs_w
        widx = torch.arange(p, device=tokens.device)[:, None]
        toks_b, z_b = tokens[widx, idx], z[widx, idx]          # [P, n, L]
        if gumbel_noise is None:
            gumbel_noise = gumbel(toks_b.shape + (cfg.num_topics,), gen,
                                  tokens.device)
        z_new = _gibbs_sweep(counts["phi"], counts["phi_tilde"], toks_b, z_b,
                             gumbel_noise, cfg)

        # Count deltas: -1 at (w, z_old), +1 at (w, z_new), per token.
        wk = widx[:, :, None].expand_as(toks_b).reshape(-1)
        w_flat = toks_b.reshape(-1).long()
        d_phi = torch.zeros_like(counts["phi"])
        one = torch.ones((), device=d_phi.device)
        d_phi.index_put_((wk, w_flat, z_new.reshape(-1).long()), one,
                         accumulate=True)
        d_phi.index_put_((wk, w_flat, z_b.reshape(-1).long()), -one,
                         accumulate=True)
        delta = {"phi": d_phi, "phi_tilde": d_phi.sum(dim=-2)}

        z_next = z.clone()
        z_next[widx, idx] = z_new
        new_state = {"tokens": tokens, "z": z_next,
                     "cursor": ((cursor + cfg.batch_docs) % docs_w).to(
                         cursor.dtype)}
        moved = (z_new != z_b).float().mean(dim=(-2, -1))
        return delta, new_state, {"frac_moved": moved}

    return update_fn


def log_likelihood(counts: Any, tokens: torch.Tensor, z: torch.Tensor,
                   cfg: LDAConfig) -> torch.Tensor:
    """Collapsed per-token log likelihood of the corpus under the current
    counts (the paper's LDA quality metric). ``tokens``/``z``: [docs,
    doc_len]."""
    k = cfg.num_topics
    theta = _doc_theta(z, k)                                   # [D, K]
    doc_len = tokens.shape[1]
    p_topic = (theta + cfg.alpha) / (doc_len + k * cfg.alpha)
    phi = torch.clamp_min(counts["phi"], 0.0)
    phit = torch.clamp_min(counts["phi_tilde"], 0.0)
    p_word = (phi + cfg.beta) / (phit + cfg.vocab * cfg.beta)  # [W, K]
    probs = torch.einsum("dk,dlk->dl", p_topic, p_word[tokens.long()])
    return torch.sum(torch.log(torch.clamp_min(probs, 1e-12)))


def init_assignments(key, tokens: torch.Tensor, cfg: LDAConfig) -> torch.Tensor:
    """Uniform topics; ``key`` is a ``torch.Generator`` (the draws differ
    from ``jax.random``'s)."""
    return torch.randint(0, cfg.num_topics, tuple(tokens.shape), generator=key,
                         device=key.device, dtype=torch.int32).to(tokens.device)
