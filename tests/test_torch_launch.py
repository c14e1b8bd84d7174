"""The port's serving launcher (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``) on the CPU, at the small config
``--n-docs 2048 --vocab 512 --requests 16 --max-batch 4``.

The JAX launcher runs in-process (argv patched, stdout captured), twice:
once building and saving a single index with a k sweep, once mmap-loading a
2-shard set the port's launcher saved. The port's launcher runs its job
(``serve_job``) four times: plain, lsp2 and bmp over the JAX launcher's
directory, and 2 shards through the host loop with a swap mid-run and a k
sweep, saving the set the JAX launcher then loads.

Held: the deterministic printed fields (NS, γ, the shard count, the backend,
the bucket ladder, the request count, swaps, failures, recompiles; batch
counts and latencies depend on timing); each directory's fingerprint, as the
other launcher prints it; every response's ids and both visit counters
equal to the JAX facade's over the same index at the launcher's config, θ
and scores at rtol 1e-5 (float32 sums in another order);
``parse_tenant_quotas`` results and errors; the flags of both launchers.
The index the port rebuilds for the swap equals the saved one (the same
fingerprint as JAX's build), so both halves of the stream are held to the
same facade.
"""

import argparse
import contextlib
import io
import re
import sys

import jax
import numpy as np
import pytest

import repro.launch.serve as jax_serve
from repro.api import DynamicParams as JaxDynamicParams, Retriever as JaxRetriever, SearchRequest as JaxRequest
from repro.api import StaticConfig as JaxStaticConfig
from repro.index import store as jax_store
from repro_torch.launch import serve

ARGS = ["--n-docs", "2048", "--vocab", "512", "--requests", "16", "--max-batch", "4"]
SWEEP = [1, 5, 10]
TOL = dict(rtol=1e-5, atol=1e-6)
# the port's runs: name -> extra flags (the JAX launcher's directory for the single-index runs)
PORT_RUNS = {
    "plain": ["--sweep-k", "1,5,10"],
    "lsp2": ["--variant", "lsp2"],
    "bmp": ["--variant", "bmp"],
    "sharded": ["--shards", "2", "--swap-mid-run", "--sweep-k", "1,5,10"],
}


def _jax_main(argv) -> str:
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(out):
            jax_serve.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def _port_job(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = serve.serve_job(serve.parse_args(argv + ["--device", "cpu"]))
    return run, out.getvalue()


def _fields(printed: str) -> dict:
    """The launcher's deterministic printed fields."""
    pats = {
        "ns": r"NS=(\d+), (\w+) γ=(\d+)(, \d+ shards)?",
        "backend": r"backend (\w+), buckets (BucketLadder\(.*\)), cache=(\d+)",
        "requests": r"\] (\d+) requests / \d+ batches",
        "swaps": r"swaps (\d+) \| failures (\d+)",
        "recompiles": r"recompiles=(\d+)",
        "fingerprint": r"(?:saved|mmap-loaded) .*\((\w{12})…\)",
    }
    return {k: (m.groups() if (m := re.search(p, printed)) else None) for k, p in pats.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    single, sharded = str(root / "jax_single"), str(root / "port_sharded")
    jax_printed = _jax_main(ARGS + ["--index-dir", single, "--sweep-k", "1,5,10"])
    port = {}
    for name, extra in PORT_RUNS.items():
        port[name] = _port_job(ARGS + extra + ["--index-dir", sharded if name == "sharded" else single])
    jax_loaded = _jax_main(ARGS + ["--shards", "2", "--index-dir", sharded])
    return dict(single=single, sharded=sharded, jax_printed=jax_printed, jax_loaded=jax_loaded, port=port)


def test_printed_fields_equal_the_jax_launchers(runs):
    want, got = _fields(runs["jax_printed"]), _fields(runs["port"]["plain"][1])
    assert want["ns"] == got["ns"] == ("16", "lsp0", "16", None)
    for key in ("backend", "requests", "swaps", "recompiles"):
        assert got[key] == want[key], key
    assert got["backend"][0] == "local" and got["swaps"] == ("0", "0") and got["recompiles"] == ("0",)
    # the 2-shard set: the port's run (a swap, a sweep) beside the JAX launcher's load of it
    got, want = _fields(runs["port"]["sharded"][1]), _fields(runs["jax_loaded"])
    assert got["ns"] == want["ns"] == ("16", "lsp0", "16", ", 2 shards")
    assert got["backend"] == want["backend"] and got["backend"][0] == "sharded"
    assert got["requests"] == ("64",) and got["swaps"] == ("1", "0") and got["recompiles"] == ("0",)


def test_each_launcher_mmap_loads_the_others_directory(runs):
    jax_saved = _fields(runs["jax_printed"])["fingerprint"]
    assert "[serve] saved index ->" in runs["jax_printed"]
    for name in ("plain", "lsp2", "bmp"):
        printed = runs["port"][name][1]
        assert f"mmap-loaded index {runs['single']}" in printed and "built index" not in printed
        assert _fields(printed)["fingerprint"] == jax_saved
    port_saved = _fields(runs["port"]["sharded"][1])["fingerprint"]
    assert "saved 2-shard index" in runs["port"]["sharded"][1]
    assert f"mmap-loaded index {runs['sharded']}" in runs["jax_loaded"]
    assert _fields(runs["jax_loaded"])["fingerprint"] == port_saved
    assert jax_store.load_index_auto(runs["sharded"]).fingerprint[:12] == port_saved[0]


def _jax_responses(index, run, params=None, shards=0):
    scfg = run.static_cfg
    retr = JaxRetriever.from_index(
        index, JaxStaticConfig(variant=scfg.variant, gamma=scfg.gamma, gamma0=scfg.gamma0, k_max=scfg.k_max),
        params=JaxDynamicParams.recommended(scfg.k_max), shards=shards, impl="ref")
    return retr.search_batch([JaxRequest(t, w, params=params) for t, w in run.queries])


def _assert_same(got, want, ctx):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.doc_ids, np.asarray(w.doc_ids), err_msg=f"{ctx} {i}")
        np.testing.assert_allclose(g.scores, np.asarray(w.scores), **TOL, err_msg=f"{ctx} {i}")
        np.testing.assert_allclose(g.theta, w.theta, **TOL, err_msg=f"{ctx} {i}")
        assert (g.n_superblocks_visited, g.n_blocks_scored) == (w.n_superblocks_visited, w.n_blocks_scored), i


@pytest.mark.parametrize("name", list(PORT_RUNS))
def test_responses_equal_the_jax_facades(runs, name):
    run, _ = runs["port"][name]
    shards = 2 if name == "sharded" else 0
    index = jax_store.load_index(runs["single"], device=True)  # the same index: the port's build equals JAX's here
    assert all(not isinstance(r, Exception) for r in run.responses) and run.summary["failures"] == 0
    _assert_same(run.responses, _jax_responses(index, run, shards=shards), name)
    if "--sweep-k" in PORT_RUNS[name]:
        beta = run.params.beta
        want = [r for k in SWEEP for r in _jax_responses(index, run, JaxDynamicParams(k=k, beta=beta), shards)]
        _assert_same(run.sweep, want, f"{name} sweep")
        assert [len(r.doc_ids) for r in run.sweep] == [k for k in SWEEP for _ in run.queries]
        assert run.recompiles == 0


@pytest.mark.parametrize("spec", ["default=100/20,teamA=500", "a=1.5/3, b =2", "default=7", "x=1,y=2/0.5,default=3/4"])
def test_parse_tenant_quotas_equals_jax(spec):
    def fields(adm):
        quota = lambda q: None if q is None else (q.rate, q.burst)  # noqa: E731
        return adm.default_deadline_ms, {k: quota(q) for k, q in adm.quotas.items()}, quota(adm.default_quota)

    assert fields(serve.parse_tenant_quotas(spec)) == fields(jax_serve.parse_tenant_quotas(spec))


@pytest.mark.parametrize("spec", ["teamA", "=5", "a=1,b", "a=x"])
def test_parse_tenant_quotas_errors_equal_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_serve.parse_tenant_quotas(spec)
    with pytest.raises(ValueError) as got:
        serve.parse_tenant_quotas(spec)
    assert str(got.value) == str(want.value)


def test_the_port_launcher_takes_every_flag_of_the_jax_one(monkeypatch):
    """Both parsers, caught as ``main`` builds them: the port has JAX's
    flags with JAX's defaults, and ``--device``."""
    parsers = []

    def catch(self, args=None, namespace=None):
        parsers.append(self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    for main in (jax_serve.main, serve.main):
        with pytest.raises(SystemExit):
            main()
    want, got = ({a.dest: (tuple(a.option_strings), a.default, a.type, a.choices) for a in p._actions}
                 for p in parsers)
    assert set(got) - set(want) == {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest


def test_a_world_of_other_size_than_the_shards_is_refused(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--shards 3 needs a process group of 3 ranks, not 2"):
        serve.main(ARGS + ["--shards", "3", "--device", "cpu"])


def test_slo_deadline_and_quota_flags_serve_on_the_cpu():
    run, printed = _port_job(ARGS + ["--slo-p99-ms", "1000", "--deadline-ms", "60000",
                                     "--tenant-quota", "default=100000/1000", "--no-buckets", "--cache-size", "0"])
    assert run.summary["requests"] == 16 and run.summary["failures"] == 0
    assert re.search(r"\[serve\] slo: degraded \d+ \| deadline_expired 0 \| quota_rejected 0 \| rejected 0 \| "
                     r"level \d+", printed)
    assert "buckets BucketLadder(batch=[4], nq=[16, 64])" in printed
    assert jax.devices()[0].platform == "cpu"  # the JAX side of this file ran on the CPU
