"""Speculative decoding in the port's serving engine, against the JAX
package.

A proposer (n-gram prompt lookup, or a draft model) guesses up to k tokens
per active request and one (k + 1)-token verify scores them. Greedy streams
must equal the plain engine's byte for byte — and the JAX speculative
engine's, and one-shot ``generate()`` — on both cache layouts and at int8
KV; drafts never overrun a request's budget, its capacity or an EOS, and a
near-dry pool makes the plain engine's ``cache_full`` decisions. Sampling
keeps the target distribution: ``top_k=1`` sampling is the greedy stream,
a seed repeats its tokens, and the second token's histogram over many
seeds stays within a total-variation bound of the plain engine's. The
proposers are held as units, the n-gram matcher against JAX's.
"""

import collections

import numpy as np
import pytest
import torch

from fleetx_tpu.serving.spec import NgramProposer as JaxNgramProposer
from fleetx_tpu_torch.models.gpt.generation import (
    GenerationConfig,
    generate,
)
from fleetx_tpu_torch.models.gpt.model import GPTForPretraining
from fleetx_tpu_torch.serving import DraftModelProposer, NgramProposer
from torch_serving_cases import (
    NO_EOS,
    jax_engine,
    port_engine,
    prompts,
    serve,
    tokens,
)
from torch_serving_cases import weights as make_weights

K = 4
# the total-variation bound of the sampling test: the second token ranges
# over nine tokens (top-4 of a distribution that hangs on the sampled
# first token), and two independent histograms of 192 such draws lie
# about 0.1 apart (0.104 here); keeping the drafted token whenever it is
# proposed would move the spec histogram by 1 - p(draft), 0.73 here
TV_BOUND = 0.2


@pytest.fixture(scope="module")
def w():
    return make_weights()


def spec_prompts():
    """The shared prompts plus one that repeats a 5-token motif (the
    n-gram proposer's best case)."""
    motif = np.asarray([11, 23, 5, 42, 7], np.int32)
    return prompts() + [np.tile(motif, 3)]


@pytest.fixture(scope="module")
def plain(w):
    """The plain engine's greedy streams, paged and slot (equal)."""
    a = tokens(serve(port_engine(w), spec_prompts(), max_length=12))
    b = tokens(serve(port_engine(w, paged=False), spec_prompts(),
                     max_length=12))
    assert a == b
    return a


@pytest.fixture(scope="module")
def jax_spec(w):
    return {paged: tokens(serve(jax_engine(w, paged=paged, spec=True,
                                           spec_k=K),
                                spec_prompts(), max_length=12))
            for paged in (True, False)}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_spec_greedy_equals_plain_and_jax_spec(w, plain, jax_spec, paged,
                                               kv):
    eng = port_engine(w, paged=paged, kv_dtype=kv, spec=True, spec_k=K)
    got = tokens(serve(eng, spec_prompts(), max_length=12))
    if kv is None:
        assert got == plain == jax_spec[paged]
    else:
        want = tokens(serve(port_engine(w, paged=paged, kv_dtype=kv),
                            spec_prompts(), max_length=12))
        assert got == want
    snap = eng.metrics.snapshot()
    assert snap["spec_proposed_tokens"] > 0
    assert 0 < snap["spec_accepted_tokens"] < snap["spec_proposed_tokens"]
    assert snap["spec_tokens_per_tick_mean"] > 1
    assert eng.cache_manager.free_count == eng.slots
    eng.cache_manager.check_invariants()


def test_spec_equals_one_shot_generate(w, plain):
    _, cfg, params = w
    model = GPTForPretraining(cfg, device="meta")
    model.load_state_dict(params, assign=True)
    for p, want in zip(spec_prompts(), plain):
        out = generate(model, torch.tensor(p[None]), GenerationConfig(
            decode_strategy="greedy", max_length=12, eos_token_id=NO_EOS))
        assert out[0, len(p):].tolist() == want


def test_spec_off_is_default_and_inert(w):
    eng = port_engine(w)
    assert eng.spec is False and eng._proposer is None
    snap = eng.metrics.snapshot()
    assert snap["spec_proposed_tokens"] == 0
    assert snap["spec_tokens_per_tick_mean"] is None


def test_drafts_clamped_to_the_budget(w):
    """k above the remaining budget: 2-token requests emit exactly 2."""
    base = tokens(serve(port_engine(w), spec_prompts(), max_length=2))
    eng = port_engine(w, spec=True, spec_k=6)
    got = tokens(serve(eng, spec_prompts(), max_length=2))
    assert got == base and all(len(t) == 2 for t in got)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_eos_inside_the_draft_window(w, plain, paged):
    """EOS = greedy's own third token: emission stops exactly there."""
    p = spec_prompts()[3]
    eos = plain[3][2]
    assert eos not in plain[3][:2]

    def run(spec):
        eng = port_engine(w, paged=paged, spec=spec, spec_k=6)
        return serve(eng, [p], max_length=12, eos_token_id=eos)[0]

    a, b = run(False), run(True)
    assert a.finish_reason == b.finish_reason == "eos"
    assert b.tokens.tolist() == a.tokens.tolist() == plain[3][:3]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_spec_at_the_cache_capacity_edge(w, paged):
    """A request decoding right up to its capacity under a large k must
    not overrun its lane or pages mid-verify, nor change a token."""
    prompt = np.arange(1, 33, dtype=np.int32)  # 32 of cache_len 40

    def run(spec):
        eng = port_engine(w, slots=1, cache_len=40, paged=paged, spec=spec,
                          spec_k=8)
        res = serve(eng, [prompt], max_length=50)[0]  # clamps to 8
        eng.cache_manager.check_invariants()
        return res

    a, b = run(False), run(True)
    assert len(a.tokens) == len(b.tokens) == 8
    assert b.tokens.tolist() == a.tokens.tolist()
    assert a.finish_reason == b.finish_reason


def test_near_dry_pool_makes_the_plain_decisions(w):
    """A pool with no slack for draft windows: pending-token pages first,
    rejected-draft pages returned the same tick — the same cache_full
    retirements and tokens as the plain engine."""
    ps = [np.arange(1, 8, dtype=np.int32), np.arange(10, 17, dtype=np.int32)]

    def run(spec):
        eng = port_engine(w, slots=2, cache_len=32, num_pages=7,
                          prefix_cache=False, spec=spec, spec_k=K)
        res = serve(eng, ps, max_length=20)
        eng.cache_manager.check_invariants()
        return [(r.finish_reason, r.tokens.tolist()) for r in res]

    base, spec = run(False), run(True)
    assert spec == base
    assert "cache_full" in {reason for reason, _ in base}


def test_ngram_proposer_matches_jax_on_random_histories():
    rng = np.random.RandomState(0)
    for n_max, n_min in ((3, 1), (2, 2), (4, 1)):
        mine, ref = NgramProposer(n_max, n_min), JaxNgramProposer(n_max,
                                                                  n_min)
        for _ in range(200):
            hist = rng.randint(0, 5, rng.randint(1, 30))
            cap = int(rng.randint(0, 6))
            want = ref.propose({0: (hist, cap)}, 4)
            got = mine.propose({0: (hist, cap)}, 4)
            assert got.keys() == want.keys()
            for slot in want:
                assert got[slot].tolist() == want[slot].tolist()
    assert NgramProposer()._match(np.asarray([1, 2, 3, 4, 1, 2]),
                                  2).tolist() == [3, 4]
    with pytest.raises(ValueError, match="min_n"):
        NgramProposer(max_n=2, min_n=3)


def test_draft_proposer_lane_lifecycle(w, plain):
    """Catch-up on the first propose, drafts equal to the model's own
    greedy continuation, observe() rewinding past a rejected tail, a full
    acceptance leaving one token to catch up, retire and reset."""
    _, cfg, params = w
    prop = DraftModelProposer(GPTForPretraining(cfg, device="meta"), params,
                              prefill_bucket=4, device="cpu")
    prop.bind(slots=2, cache_len=48)
    p = spec_prompts()[0]
    out = prop.propose({0: (p, 3)}, k=3)
    assert out[0].tolist() == plain[0][:3]
    assert prop.lengths[0] == len(p) - 1
    assert prop.single_token_forwards == 3
    prop.observe(0, emitted=1)
    assert prop.lengths[0] == len(p)
    hist = np.concatenate([p, plain[0][:2]])
    out = prop.propose({0: (hist, 3)}, k=3)
    assert out[0].tolist() == plain[0][2:5]
    prop.observe(0, emitted=4)  # all 3 accepted + the correction token
    assert prop.lengths[0] == len(hist) - 1 + 3
    prop.on_retire(0)
    assert prop.lengths[0] == 0
    prop.reset()
    assert not prop._written and (prop.lengths == 0).all()


def test_spec_draft_variable_resolution(w, monkeypatch):
    assert port_engine(w, spec=True)._proposer.name == "ngram"
    monkeypatch.setenv("FLEETX_SERVING_SPEC_DRAFT", "self")
    assert port_engine(w, spec=True)._proposer.name == "draft"
    monkeypatch.setenv("FLEETX_SERVING_SPEC_DRAFT", "nope")
    with pytest.raises(ValueError, match="SPEC_DRAFT"):
        port_engine(w, spec=True)
    monkeypatch.delenv("FLEETX_SERVING_SPEC_DRAFT")
    with pytest.raises(ValueError, match="spec_k"):
        port_engine(w, spec=True, spec_k=0)
    monkeypatch.setenv("FLEETX_SERVING_SPEC", "1")
    monkeypatch.setenv("FLEETX_SERVING_SPEC_K", "3")
    eng = port_engine(w)
    assert eng.spec and eng.spec_k == 3


def test_proposer_keyword_implies_spec(w):
    eng = port_engine(w, spec_proposer=NgramProposer())
    assert eng.spec is True and eng._proposer is not None
    with pytest.raises(ValueError, match="spec_proposer"):
        port_engine(w, spec=False, spec_proposer=NgramProposer())


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_self_draft_accepts_every_draft(w, plain, paged, monkeypatch):
    monkeypatch.setenv("FLEETX_SERVING_SPEC_DRAFT", "self")
    eng = port_engine(w, paged=paged, spec=True, spec_k=3)
    assert tokens(serve(eng, spec_prompts(), max_length=12)) == plain
    assert eng.metrics.snapshot()["spec_acceptance_rate"] == 1.0


def test_top_k_1_sampling_equals_greedy(w, plain):
    eng = port_engine(w, spec=True, spec_k=K)
    got = tokens(serve(eng, spec_prompts(), max_length=12,
                       decode_strategy="sampling", top_k=1))
    assert got == plain
    assert eng.metrics.snapshot()["spec_accepted_tokens"] > 0


def test_seeded_spec_sampling_repeats(w):
    def run(seed):
        eng = port_engine(w, spec=True, spec_k=K)
        return tokens(serve(eng, spec_prompts(), max_length=12,
                            decode_strategy="sampling", temperature=1.2,
                            top_k=8, seed=seed))

    a, b, c = run(5), run(5), run(6)
    assert a == b != c


class FixedProposer(NgramProposer):
    """Drafts ``token`` at every position: the rejection path is taken
    with probability 1 - p(token) at each."""

    name = "fixed"

    def __init__(self, token: int):
        super().__init__()
        self.token = token

    def propose(self, requests, k):
        return {s: np.full(min(cap, k), self.token, np.int32)
                for s, (_, cap) in requests.items() if cap > 0}


def test_spec_sampling_keeps_the_target_distribution(w):
    """The second token (the first one the verify draws) over 192 seeds:
    spec against plain within TV_BOUND, with a proposer that drafts the
    plain histogram's mode at every position."""
    p = np.asarray([5, 9, 2], np.int32)
    gen_cfg = GenerationConfig(decode_strategy="sampling",
                               eos_token_id=NO_EOS, top_k=4)

    def second_tokens(**kw):
        eng = port_engine(w, slots=8, cache_len=16, gen_cfg=gen_cfg, **kw)
        rids = [eng.submit(p, max_length=3, seed=1000 + i)
                for i in range(192)]
        res = eng.drain()
        return eng, collections.Counter(int(res[r].tokens[1]) for r in rids)

    _, off = second_tokens()
    mode = off.most_common(1)[0][0]
    eng, on = second_tokens(spec_proposer=FixedProposer(mode))
    snap = eng.metrics.snapshot()
    assert 0 < snap["spec_accepted_tokens"] < snap["spec_proposed_tokens"]
    assert len(off) > 1 and set(on) <= set(off) | set(on)
    tv = 0.5 * sum(abs(off[t] - on[t]) for t in set(off) | set(on)) / 192
    assert tv < TV_BOUND, (tv, off, on)
    # the bound has teeth: always keeping the draft moves the histogram
    always = collections.Counter({mode: 192})
    tv_fault = 0.5 * sum(abs(off[t] - always[t])
                         for t in set(off) | {mode}) / 192
    assert tv_fault > TV_BOUND
