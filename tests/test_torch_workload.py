"""The port's seeded workload traces and goodput scorer against the JAX
package's ``serving/workload.py``.

Traces from the same spec and seed are bit-identical (arrivals, tenants,
prompts, lengths, deadlines) with equal ``trace_hash``, over both
distributions, bursts, shared prefixes and several seeds; the scorer gives
the same record on the same outcomes; ``run_trace`` drives a host stub the
same way in both packages.
"""

import dataclasses

import numpy as np
import pytest

from fleetx_tpu.serving import workload as jax_workload
from fleetx_tpu_torch.serving import workload
from fleetx_tpu_torch.serving import ServingResult


def specs(mod):
    """The specs of the comparison, built from ``mod``'s dataclasses."""
    T, W = mod.TenantSpec, mod.WorkloadSpec
    mixed = (T("chat", weight=2.0, prompt_len=(3, 8), gen_len=(2, 5),
               ttft_deadline_s=0.5, tpot_deadline_ms=40.0),
             T("tmpl", weight=1.0, prompt_len=(10, 14), gen_len=(2, 5),
               shared_prefix_len=8, abandon_s=2.0))
    out = {}
    for dist in ("poisson", "azure_llm"):
        for seed in (0, 5, 11):
            out[(dist, seed, "mixed")] = W(
                seed=seed, n_requests=40, arrival_rate=50.0, vocab=61,
                tenants=mixed, burst_every_s=0.2, burst_len_s=0.08,
                burst_factor=5.0, distribution=dist)
        out[(dist, 3, "default")] = W(seed=3, n_requests=64,
                                      distribution=dist)
        out[(dist, 7, "long")] = W(
            seed=7, n_requests=32, arrival_rate=8.0, vocab=50304,
            tenants=(T("long", prompt_len=(32, 512), gen_len=(16, 32)),),
            distribution=dist)
    out[("disagg", 7, "spec")] = mod.disagg_spec(16, vocab=61,
                                                 prompt_len=(9, 20))
    return out


@pytest.mark.parametrize("key", sorted(specs(workload)),
                         ids=lambda k: "-".join(map(str, k)))
def test_trace_bit_identical_to_jax(key):
    got = workload.generate_trace(specs(workload)[key])
    want = jax_workload.generate_trace(specs(jax_workload)[key])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.index == b.index and a.tenant == b.tenant
        assert a.arrival_s == b.arrival_s  # the same float, bit for bit
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.max_new_tokens, a.ttft_deadline_s, a.tpot_deadline_ms,
                a.abandon_s) == (b.max_new_tokens, b.ttft_deadline_s,
                                 b.tpot_deadline_ms, b.abandon_s)
    assert workload.trace_hash(got) == jax_workload.trace_hash(want)


def test_trace_seed_and_shape_contract():
    """Same spec, same trace; another seed, another hash; arrivals sorted;
    bursts pin to the shared-prefix tenant, whose prompts share it."""
    spec = specs(workload)[("poisson", 5, "mixed")]
    t1, t2 = workload.generate_trace(spec), workload.generate_trace(spec)
    assert workload.trace_hash(t1) == workload.trace_hash(t2)
    other = dataclasses.replace(spec, seed=6)
    assert (workload.trace_hash(workload.generate_trace(other))
            != workload.trace_hash(t1))
    assert [r.arrival_s for r in t1] == sorted(r.arrival_s for r in t1)
    tmpl = [r for r in t1 if r.tenant == "tmpl"]
    assert all(np.array_equal(r.prompt[:8], tmpl[0].prompt[:8])
               for r in tmpl)
    in_burst = [r for r in t1
                if (r.arrival_s % spec.burst_every_s) < spec.burst_len_s]
    assert in_burst and all(r.tenant == "tmpl" for r in in_burst)


@pytest.mark.parametrize("bad", [dict(n_requests=0), dict(arrival_rate=0.0),
                                 dict(tenants=()),
                                 dict(distribution="nope")])
def test_trace_refusals_match_jax(bad):
    for mod in (workload, jax_workload):
        with pytest.raises(ValueError):
            mod.generate_trace(dataclasses.replace(mod.WorkloadSpec(),
                                                   **bad))


def outcomes(mod):
    O = mod.RequestOutcome
    return [
        O(index=0, tenant="a", finish_reason="eos", n_tokens=5, ttft_s=0.1,
          tpot_ms=10.0, ttft_deadline_s=1.0, tpot_deadline_ms=100.0),
        O(index=1, tenant="a", finish_reason="max_length", n_tokens=4,
          ttft_s=2.0, tpot_ms=10.0, ttft_deadline_s=1.0),
        O(index=2, tenant="b", finish_reason="rejected",
          ttft_deadline_s=1.0),
        O(index=3, tenant="b", finish_reason="timeout", n_tokens=0,
          ttft_deadline_s=1.0),
        O(index=4, tenant="c", finish_reason="max_length", n_tokens=7,
          ttft_s=0.3, tpot_ms=250.0, tpot_deadline_ms=100.0),
        O(index=5, tenant="c", finish_reason="cancelled", n_tokens=2,
          ttft_s=0.05, tpot_ms=3.0),
    ]


def test_score_goodput_equals_jax():
    got = workload.score_goodput(outcomes(workload))
    assert got == jax_workload.score_goodput(outcomes(jax_workload))
    assert got["good"] == 1 and got["goodput"] == round(1 / 6, 4)
    assert got["goodput_per_tenant"] == {"a": 0.5, "b": 0.0, "c": 0.0}
    for mod in (workload, jax_workload):
        with pytest.raises(ValueError):
            mod.score_goodput([])


class _Stub:
    """Host-only target: each step emits one token per live request and
    finishes it after ``finish_after`` tokens; ``cancel`` retires."""

    def __init__(self, finish_after):
        self.finish_after = finish_after
        self._next, self._live, self._results = 0, {}, {}

    def submit(self, prompt, *, max_length, on_token):
        rid = self._next
        self._next += 1
        self._live[rid] = {"cb": on_token, "n": 0, "p": np.asarray(prompt)}
        return rid

    def _result(self, rid, rec, reason):
        self._results[rid] = ServingResult(
            id=rid, prompt=rec["p"], tokens=np.arange(rec["n"],
                                                      dtype=np.int32),
            finish_reason=reason, ttft_s=0.0, latency_s=0.0)

    def step(self):
        for rid, rec in list(self._live.items()):
            rec["n"] += 1
            done = rec["n"] >= self.finish_after
            rec["cb"](rid, rec["n"], done)
            if done:
                self._result(rid, rec, "max_length")
                del self._live[rid]

    def cancel(self, rid):
        rec = self._live.pop(rid, None)
        if rec is not None:
            self._result(rid, rec, "cancelled")
        return rec is not None

    def take_result(self, rid):
        return self._results.pop(rid, None)


def test_run_trace_outcomes_and_abandonment():
    """A patient trace completes with every token counted; an impatient
    tenant is cancelled past its patience (the clock is a counter, so
    the timings are exact)."""
    for abandon, reason in ((0.0, "max_length"), (2.5, "cancelled")):
        spec = workload.WorkloadSpec(
            seed=1, n_requests=6, arrival_rate=500.0, vocab=61,
            tenants=(workload.TenantSpec("t", prompt_len=(2, 4),
                                         gen_len=(2, 4),
                                         abandon_s=abandon),))
        trace = workload.generate_trace(spec)
        clock = iter(np.arange(0.0, 1e5, 0.25))
        outs = workload.run_trace(_Stub(finish_after=20), trace,
                                  now=lambda: float(next(clock)),
                                  keep_tokens=True)
        assert [o.index for o in outs] == list(range(6))
        assert {o.finish_reason for o in outs} == {reason}
        for o in outs:
            assert o.n_tokens == len(o.tokens) and o.ttft_s > 0
            if reason == "max_length":
                assert o.n_tokens == 20 and o.tpot_ms is not None
