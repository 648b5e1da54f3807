"""Autoregressive generation: knobs, the decode cache, one cached forward,
the logits processors, the sampler and the one-shot ``generate()`` loop.

Port of the JAX package's ``models/gpt/generation.py``. The decode cache
is a dict of tensors stacked over the layers, in one of two layouts:

- contiguous (one-shot ``generate()``): ``key``/``value`` ``[L, b,
  cache_len, h, d]`` and the scalar write offset ``index`` (the JAX tree's
  ``cached_key``/``cached_value``/``cache_index`` leaves);
- paged (the serving engine, ``cfg.decode_num_pages`` set): ``key``/
  ``value`` pools ``[L, num_pages, page_size, h, d]``.

At ``cfg.decode_kv_dtype == "int8"`` ``key``/``value`` are int8 and fp32
``key_scale``/``value_scale`` tensors ``[..., h, 1]`` ride beside them
(``cached_key_scale``/``cached_value_scale``).

The JAX loop is a compiled ``while_loop``; here it is a Python loop over
eager steps. Beam search is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from fleetx_tpu_torch.models.gpt.model import pad_starts, refuse_moe_serving
from fleetx_tpu_torch.utils.device import resolve_device

__all__ = ["GenerationConfig", "decode_step", "generate", "init_decode_cache",
           "mark_seen", "process_logits", "prompt_seen",
           "right_size_decode_cache"]

_NEG = -1e9
# the loop reads "every row finished" from the card once per this many
# steps; the extra steps it may run emit padding, as finished rows do
_FINISHED_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode-strategy knobs (the reference ``Generation`` section)."""
    max_length: int = 64  # new tokens to generate
    min_length: int = 0
    decode_strategy: str = "sampling"  # 'greedy' | 'sampling' | 'beam_search'
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    forced_eos_token_id: Optional[int] = None
    num_beams: int = 1
    num_beam_groups: int = 1
    diversity_rate: float = 0.0
    length_penalty: float = 0.0
    early_stopping: bool = False
    forced_bos_token_id: Optional[int] = None
    num_return_sequences: int = 1

    @classmethod
    def from_config(cls, gen_cfg) -> "GenerationConfig":
        d = dict(gen_cfg or {})
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known and v is not None}
        if d.get("max_dec_len") is not None:
            kw["max_length"] = d["max_dec_len"]
        if d.get("min_dec_len") is not None:
            kw["min_length"] = d["min_dec_len"]
        # keys other components read from the Generation section
        aliases = {"max_dec_len", "min_dec_len", "use_cache", "vocab_dir",
                   "seed"}
        ignored = sorted(k for k in d if k not in known and k not in aliases)
        if ignored:
            from fleetx_tpu_torch.utils.log import logger

            logger.warning(
                "GenerationConfig.from_config ignoring unknown keys %s "
                "(known: %s)", ignored, sorted(known | aliases))
        return cls(**kw)


def init_decode_cache(model, batch: Optional[int] = None, *,
                      cache_len: Optional[int] = None,
                      device=None) -> Dict:
    """Zeroed decode cache for ``model`` (module docstring for the two
    layouts). Paged when ``model.cfg.decode_num_pages`` is set — ``batch``
    is then unused; page 0 is the trash page that zeroed block-table
    entries point at. Else contiguous for ``batch`` rows of ``cache_len``
    positions (default: ``cfg.cache_len``). ``device`` defaults to CUDA.
    Under ``mp_degree > 1`` it holds this rank's ``heads / mp`` heads."""
    cfg = model.cfg
    dev = resolve_device(device)
    nh, hd = cfg.num_attention_heads // cfg.mp_degree, cfg.head_dim
    if cfg.decode_num_pages is not None:
        if cfg.decode_page_size is None:
            raise ValueError("a paged decode cache needs decode_page_size")
        lead = (cfg.num_layers, cfg.decode_num_pages, cfg.decode_page_size)
        cache = {}
    else:
        if batch is None:
            raise ValueError("a contiguous decode cache needs its batch")
        lead = (cfg.num_layers, batch, cache_len or cfg.cache_len)
        cache = {"index": 0}
    quant = cfg.decode_kv_dtype == "int8"
    if cfg.decode_kv_dtype not in (None, "int8"):
        raise ValueError(f"decode_kv_dtype must be None or 'int8', got "
                         f"{cfg.decode_kv_dtype!r}")
    kv_dtype = torch.int8 if quant else cfg.dtype
    for name in ("key", "value"):
        cache[name] = torch.zeros(lead + (nh, hd), dtype=kv_dtype, device=dev)
        if quant:
            cache[name + "_scale"] = torch.zeros(lead + (nh, 1),
                                                 dtype=torch.float32,
                                                 device=dev)
    return cache


def right_size_decode_cache(model, total_len: int) -> int:
    """The contiguous cache length a decode of ``total_len`` positions
    uses: ``cfg.decode_cache_len`` when preset (raising if it cannot hold
    the decode — an undersized cache would clamp writes onto its last
    slot), else ``total_len`` rounded up to the decode kernels' 8-row tile
    where the decode steps take them: always on the card, and under
    ``use_flash_attention`` on the CPU, as in the JAX function (the
    kernels never read past the live window, so the extra slots cost
    nothing). The JAX function clones the model with that length; the
    port's cache carries it in its shape."""
    cache_len = model.cfg.decode_cache_len
    if cache_len is None:
        cache_len = total_len
        if model.cfg.use_flash_attention or model.gpt.word_embeddings.is_cuda:
            cache_len += -cache_len % 8
    if cache_len < total_len:
        raise ValueError(f"decode_cache_len({cache_len}) cannot hold "
                         f"prompt_len + max_length = {total_len}")
    return cache_len


@torch.no_grad()
def decode_step(model, cache: Dict, input_ids, position_ids, kv_mask=None,
                *, cache_positions=None, block_tables=None, kv_starts=None):
    """One cached forward: ``(logits, cache)``. ``input_ids``/
    ``position_ids`` [b, s]; ``s == 1`` is a decode step (the decode
    kernels), ``s > 1`` a prefill call. ``kv_mask`` [b, 1, 1, cache_len]
    marks the cache slots that hold real tokens; ``kv_starts`` [b], its
    first True (:func:`pad_starts`), may be passed to spare computing it
    on every step. Without
    ``cache_positions`` every row writes at the contiguous cache's
    ``index``; with them row b writes at ``cache_positions[b]`` (through
    ``block_tables`` on a paged cache). The cache is updated in place and
    returned for symmetry with the JAX function, which returns a new one."""
    logits = model(input_ids, position_ids, cache=cache,
                   cache_positions=cache_positions,
                   block_tables=block_tables, kv_mask=kv_mask,
                   kv_starts=kv_starts)
    return logits, cache


def process_logits(logits: torch.Tensor, seen: Optional[torch.Tensor],
                   cur_len: int, cfg: GenerationConfig, *,
                   prompt_len: int = 0,
                   total_len: Optional[int] = None) -> torch.Tensor:
    """Min-length EOS ban, repetition penalty and forced EOS, in that order
    (JAX :73). ``cur_len`` is the absolute buffer position: EOS is banned
    while ``cur_len < prompt_len + min_length``; ``seen`` is the [b, vocab]
    bool scoreboard the repetition penalty reads; forced EOS fires at the
    buffer's last slot ``total_len - 1``."""
    vocab = logits.shape[-1]
    if cfg.min_length > 0 and cur_len < prompt_len + cfg.min_length \
            and 0 <= cfg.eos_token_id < vocab:
        logits = logits.clone()
        logits[:, cfg.eos_token_id] = _NEG
    if cfg.repetition_penalty != 1.0:
        if seen is None:
            raise ValueError("repetition_penalty != 1.0 needs a seen-token "
                             "scoreboard (see prompt_seen/mark_seen)")
        penalized = torch.where(logits > 0, logits / cfg.repetition_penalty,
                                logits * cfg.repetition_penalty)
        logits = torch.where(seen, penalized, logits)
    if cfg.forced_eos_token_id is not None:
        if total_len is None:
            raise ValueError("forced_eos_token_id needs total_len")
        if cur_len >= total_len - 1:
            logits = torch.full_like(logits, _NEG)
            logits[:, cfg.forced_eos_token_id] = 0.0
    return logits


def prompt_seen(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """[b, vocab] bool scoreboard of the tokens each prompt row holds
    (left-pad slots excluded)."""
    counts = torch.zeros(input_ids.shape[0], vocab, dtype=torch.int32,
                         device=input_ids.device)
    counts.scatter_add_(1, input_ids.long(),
                        attention_mask.to(torch.int32))
    return counts > 0


def mark_seen(seen: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Fold one token per row [b] into the scoreboard (in place)."""
    seen[torch.arange(seen.shape[0], device=seen.device), tok.long()] = True
    return seen


def _top_p_cutoff_bisect(logits: torch.Tensor, top_p, iters: int = 40):
    """``(probs, t)``: the probability threshold t such that keeping
    ``probs >= t`` matches the smallest descending prefix with cumulative
    probability >= ``top_p`` (a float or a [b, 1] tensor; rows with
    ``top_p >= 1`` keep everything). Forty bisection steps of one masked
    sum each, as in the JAX package, so both filters keep the same set."""
    probs = torch.softmax(logits.float(), dim=-1)
    lo = torch.zeros((logits.shape[0], 1), dtype=torch.float32,
                     device=logits.device)
    hi = torch.full_like(lo, 1.1)  # mass(>= 1.1) == 0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid, probs, 0.0).sum(-1, keepdim=True)
        keep = mass >= top_p
        lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
    return probs, lo


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            cfg: GenerationConfig) -> torch.Tensor:
    """Next token per row (JAX ``_sample``, :237): the argmax when greedy;
    else temperature, then top-k through one ``torch.topk`` with top-p
    inside the top-k survivors, or — top-k off — the bisected top-p
    threshold, and one categorical draw from ``generator``. Removed
    entries sit at -1e9 and get probability exactly 0, so the draw stays
    in the filtered support (the draws themselves differ from
    ``jax.random``'s)."""
    if cfg.decode_strategy == "greedy":
        return torch.argmax(logits, dim=-1)
    logits = logits / max(cfg.temperature, 1e-6)
    vocab = logits.shape[-1]
    top_k = min(cfg.top_k, vocab)
    if 0 < top_k < vocab:
        vals = torch.topk(logits, top_k, dim=-1).values  # descending
        logits = torch.where(logits < vals[:, -1:], _NEG, logits)
        if cfg.top_p < 1.0:
            cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
            cutoff_idx = (cum < cfg.top_p).sum(-1, keepdim=True).clamp_max(
                top_k - 1)
            cutoff = vals.gather(-1, cutoff_idx)
            logits = torch.where(logits < cutoff, _NEG, logits)
    elif cfg.top_p < 1.0:
        probs, thresh = _top_p_cutoff_bisect(logits, cfg.top_p)
        logits = torch.where(probs >= thresh, logits, _NEG)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, input_ids: torch.Tensor, gen_cfg: GenerationConfig, *,
             attention_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[b, prompt_len + max_length]`` int32 tokens, padded after EOS (JAX
    ``generate``, :269-378), on ``model``'s device.

    The prefill runs the whole prompt once into a contiguous cache sized
    by :func:`right_size_decode_cache`; then one token per step through
    :func:`decode_step`, whose attention is the decode kernels (B7, or B9
    at ``decode_kv_dtype="int8"``). ``attention_mask`` [b, prompt_len]
    marks real prompt tokens (0 = a left pad): pad slots are never
    attended, and positions shift so each row's first real token sits at
    position 0. Finished rows emit ``pad_token_id``; the loop ends when
    every row has finished. ``generator`` drives the sampling draws."""
    if gen_cfg.decode_strategy == "beam_search":
        raise NotImplementedError(
            "beam search is not ported yet (ROADMAP Queue A, \"Beam "
            "search\")")
    refuse_moe_serving(model.cfg)
    b, prompt_len = input_ids.shape
    total_len = prompt_len + gen_cfg.max_length
    max_pos = model.cfg.max_position_embeddings
    if total_len > max_pos:
        raise ValueError(
            f"prompt_len({prompt_len}) + max_length({gen_cfg.max_length}) "
            f"exceeds max_position_embeddings({max_pos})")
    dev = model.gpt.word_embeddings.device
    cache_len = right_size_decode_cache(model, total_len)
    input_ids = input_ids.to(dev, torch.int64)
    if attention_mask is None:
        attention_mask = torch.ones(b, prompt_len, dtype=torch.int32)
    attention_mask = attention_mask.to(dev, torch.int32)
    # per-row left-pad count: the token at buffer slot i sits at position
    # i - pad_count
    pad_counts = prompt_len - attention_mask.sum(dim=1)
    kv_valid = torch.cat([attention_mask.bool(),
                          torch.ones(b, cache_len - prompt_len,
                                     dtype=torch.bool, device=dev)], dim=1)
    kv_mask = kv_valid[:, None, None, :]  # [b, 1, 1(q), cache_len(kv)]
    kv_starts = pad_starts(kv_mask)  # the decode window's start, per row
    tokens = torch.full((b, total_len), gen_cfg.pad_token_id,
                        dtype=torch.int32, device=dev)
    tokens[:, :prompt_len] = input_ids.to(torch.int32)
    cache = init_decode_cache(model, b, cache_len=cache_len, device=dev)

    pos = (torch.cumsum(attention_mask, dim=1) - 1).clamp_min(0)
    logits, cache = decode_step(model, cache, input_ids, pos, kv_mask)
    vocab = logits.shape[-1]
    track_seen = gen_cfg.repetition_penalty != 1.0
    seen = (prompt_seen(input_ids, attention_mask, vocab) if track_seen
            else None)
    next_logits = process_logits(logits[:, -1, :], seen, prompt_len,
                                 gen_cfg, prompt_len=prompt_len,
                                 total_len=total_len)
    tok = _sample(next_logits, generator, gen_cfg).to(torch.int32)
    tokens[:, prompt_len] = tok
    if track_seen:
        mark_seen(seen, tok)
    finished = tok == gen_cfg.eos_token_id
    for i in range(prompt_len + 1, total_len):
        if ((i - prompt_len - 1) % _FINISHED_CHECK_EVERY == 0
                and bool(finished.all())):
            break
        # a finished row feeds its pad token; clamp it into the vocab as
        # the JAX gather clamps an out-of-range index (its output is unused)
        cur = tokens[:, i - 1:i].long().clamp_(0, vocab - 1)
        logits, cache = decode_step(model, cache, cur,
                                    (i - 1 - pad_counts).long()[:, None],
                                    kv_mask, kv_starts=kv_starts)
        nl = process_logits(logits[:, -1, :], seen, i, gen_cfg,
                            prompt_len=prompt_len, total_len=total_len)
        tok = _sample(nl, generator, gen_cfg).to(torch.int32)
        tok = torch.where(finished, gen_cfg.pad_token_id, tok)
        tokens[:, i] = tok
        if track_seen:
            mark_seen(seen, tok)
        finished |= tok == gen_cfg.eos_token_id
    return tokens
