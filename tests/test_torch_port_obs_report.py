"""The port's journal readers and its last journal sites against the JAX
package, on the CPU.

1. **report**: ``obs/report.render_path`` gives the JAX renderer's bytes on
   the golden events of ``tests/test_obs.py`` (and the banked golden
   file) and on every banked evidence journal, with and without
   ``lineage``; its two refusals hold.  ``obs top``'s frame equals the JAX
   frame on the same events.
2. **ctl**: the port's scenario replay (``loop/ctl_scenarios``) matches the
   banked ``docs/ctl_contracts/`` traces, and ``obs dryrun --ctl`` exits 0
   with a schema-clean journal that ``report`` and ``top`` read.
3. **token events**: a ``PagedDecoder`` with a Recorder armed, alone or as
   the replicas of a ``TokenRouter``, journals the JAX decoder's ``token`` events, field for field but the walls, on the
   same weights (``interop``) and the same requests; ``bucket`` is the
   rows the port's prefill ran (always ``slots``; the JAX decoder pads to
   a ladder).
4. **feed events**: a ``ProcessPipeline`` over the same records and its
   ``device_feed`` journal the JAX ring's ``feed`` and ``.put`` events,
   field for field but the walls.
"""

import gc
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.data import pipeline as jpipe  # noqa: E402
from sparknet_tpu.data import records as jrec  # noqa: E402
from sparknet_tpu.obs import __main__ as jobs_main  # noqa: E402
from sparknet_tpu.obs import metrics as jmetrics  # noqa: E402
from sparknet_tpu.obs import recorder as jrecorder  # noqa: E402
from sparknet_tpu.obs import report as jreport  # noqa: E402
from sparknet_tpu.serve.paged import PagedDecoder as JaxPagedDecoder  # noqa: E402
from sparknet_tpu.serve.paged import TokenRouter as JaxTokenRouter  # noqa: E402

from sparknet_tpu_torch import interop  # noqa: E402
from sparknet_tpu_torch.data import lmdb_io, pipeline, records  # noqa: E402
from sparknet_tpu_torch.data.io_utils import array_to_datum  # noqa: E402
from sparknet_tpu_torch.loop import ctl_scenarios  # noqa: E402
from sparknet_tpu_torch.obs import __main__ as obs_main  # noqa: E402
from sparknet_tpu_torch.obs import metrics, report, schema  # noqa: E402
from sparknet_tpu_torch.obs import recorder as precorder  # noqa: E402
from sparknet_tpu_torch.serve.engine import AdmissionRefused  # noqa: E402
from sparknet_tpu_torch.serve.paged import PagedDecoder, TokenRouter  # noqa: E402

import test_obs  # noqa: E402  (the JAX package's report tests: GOLDEN_EVENTS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOURNALS = sorted(glob.glob(os.path.join(REPO, "docs", "evidence_r*", "*.jsonl")))
# the fields a journal line carries that are walls or stamps, not results
WALLS = {"utc", "run_id", "wall_s", "wall_ms", "ttft_ms", "total_ms", "inter_token_p50_ms",
         "inter_token_max_ms", "images_per_sec", "stages"}


@pytest.fixture
def golden(tmp_path):
    path = tmp_path / "golden.jsonl"
    path.write_text("".join(json.dumps(ev) + "\n" for ev in test_obs.GOLDEN_EVENTS))
    return str(path)


@pytest.mark.parametrize("lineage", [False, True])
def test_report_matches_jax_on_the_golden_events(golden, lineage):
    text = report.render_path(golden, lineage=lineage)
    assert text == jreport.render_path(golden, lineage=lineage)
    if not lineage:
        with open(os.path.join(REPO, "tests", "data", "obs_report_golden.md"),
                  encoding="utf-8") as f:
            assert text == f.read()


@pytest.mark.parametrize("lineage", [False, True])
@pytest.mark.parametrize("path", JOURNALS, ids=lambda p: os.path.relpath(p, REPO))
def test_report_matches_jax_on_the_evidence_journals(path, lineage):
    assert report.render_path(path, lineage=lineage) == jreport.render_path(
        path, lineage=lineage)


def test_report_refusals():
    """Unstamped walls withheld; a throughput above its stated bound
    refused, never printed."""
    text = report.render(test_obs.GOLDEN_EVENTS, source="t")
    assert "REFUSED (unfenced)" in text and "192.0" not in text
    assert "span closed without a fence stamp" in text
    assert "REFUSED — value exceeds its stated roofline bound" in text
    assert "99999" not in text


def _fold(path, hub_mod):
    hub = hub_mod.MetricsHub(flush_every=1 << 62)
    recent, folded = [], 0
    for ev in schema.stream_journal(path):
        if isinstance(ev.get("event"), str):
            hub.observe_event(ev["event"], ev)
            folded += 1
            if ev["event"] == "ctl" and ev.get("kind") in ("decide", "act", "cooldown"):
                recent = (recent + [ev])[-5:]
    return folded, hub, recent


@pytest.mark.parametrize("which", ["golden", "replica", "loop"])
def test_top_frame_matches_jax(golden, which):
    path = golden if which == "golden" else os.path.join(
        REPO, "docs", "evidence_r7", f"{which}_dryrun.jsonl")
    n, hub, recent = _fold(path, metrics)
    jn, jhub, jrecent = _fold(path, jmetrics)
    frame = obs_main._top_frame(path, n, hub, recent)
    assert frame == jobs_main._top_frame(path, jn, jhub, jrecent)
    assert frame.startswith(f"== obs top {path}")


def test_ctl_replay_matches_the_banked_contracts(tmp_path, capsys):
    summary = ctl_scenarios.replay(journal_dir=str(tmp_path / "arms"), log=lambda m: None)
    assert summary["ok"], summary["problems"]
    for record in summary["scenarios"]:
        name = record["controlled"]["scenario"]
        with open(ctl_scenarios.manifest_path(name), encoding="utf-8") as f:
            banked = json.load(f)
        assert record["controlled"]["actions"] == banked["actions"]
        assert record["bare"]["slo_burned"] == banked["bare_burned"]
    # the CLI leg: the controlled journals concatenated, schema-clean,
    # rendered and tailed
    out = str(tmp_path / "ctl.jsonl")
    assert obs_main.main(["dryrun", "--ctl", "--out", out]) == 0
    assert obs_main.main(["validate", out]) == 0
    assert obs_main.main(["report", out, "--lineage", "--out", str(tmp_path / "r.md")]) == 0
    assert (tmp_path / "r.md").read_text() == jreport.render_path(out, lineage=True)
    assert obs_main.main(["top", "--once", out]) == 0
    assert "ctl decisions (most recent last)" in capsys.readouterr().out


def _events(path, kind):
    return [{k: v for k, v in ev.items() if k not in WALLS}
            for ev in schema.stream_journal(path) if ev.get("event") == kind]


@pytest.mark.parametrize("replicas", [0, 2], ids=["decoder", "router"])
def test_token_events_match_jax(tmp_path, replicas):
    """One decoder (``replicas=0``), or a ``TokenRouter`` of two, whose
    replicas journal under the notes ``token_router/r<i>``."""
    geo = dict(slots=4, seq_len=16, vocab=32, embed_dim=32, heads=4, ffn_dim=32,
               blocks=2, seed=0, block_tokens=4)
    rs = np.random.RandomState(3)
    reqs = [(list(rs.randint(0, 32, rs.randint(1, 4))), int(rs.randint(2, 9)))
            for _ in range(9)]
    jrec_ = jrecorder.Recorder(str(tmp_path / "j.jsonl"))
    jd = (JaxTokenRouter(replicas, **geo, recorder=jrec_) if replicas
          else JaxPagedDecoder(**geo, recorder=jrec_))
    for p, m in reqs:
        jd.submit(p, m)
    jd.run()
    jrec_.close()
    jvars = jd.decoders[0].variables if replicas else jd.variables
    weights = interop.netvars_from_numpy(jvars.params, jvars.state, device="cpu")
    rec = precorder.Recorder(str(tmp_path / "p.jsonl"))
    kw = dict(**geo, variables=weights, device="cpu", hbm_bytes=16 << 30, recorder=rec)
    d = TokenRouter(replicas, **kw) if replicas else PagedDecoder(**kw)
    for p, m in reqs:
        d.submit(p, m)
    d.run()
    rec.close()
    want, got = _events(tmp_path / "j.jsonl", "token"), _events(tmp_path / "p.jsonl", "token")
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    # the router's run drains its replicas by sweeps and journals no summary
    assert {e["kind"] for e in got} == (
        {"request", "prefill"} if replicas else {"request", "prefill", "summary"})
    assert {e["note"] for e in got} == (
        {f"token_router/r{i}" for i in range(replicas)} if replicas else {"paged"})
    for a, b in zip(got, want):
        if a["kind"] == "prefill":
            assert a["bucket"] == geo["slots"] and b["bucket"] >= b["rows"]
            a, b = {**a, "bucket": 0}, {**b, "bucket": 0}
        assert a == b
    # a walled field is there and is a number
    raw = [ev for ev in schema.stream_journal(str(tmp_path / "p.jsonl"))
           if ev.get("kind") == "request"]
    assert all(ev["ttft_ms"] >= 0 and ev["total_ms"] >= ev["ttft_ms"] for ev in raw)
    n, _, errors = schema.validate_journal(str(tmp_path / "p.jsonl"))
    assert n and not errors
    # admission refused: the event before the raise
    rec = precorder.Recorder(str(tmp_path / "r.jsonl"))
    with pytest.raises(AdmissionRefused, match="model load refused"):
        PagedDecoder(**geo, device="cpu", hbm_bytes=1 << 10, recorder=rec)
    rec.close()
    (ref,) = _events(tmp_path / "r.jsonl", "token")
    assert ref["kind"] == "admission_refused" and ref["blocks_total"] == 16


def test_feed_events_match_jax(tmp_path):
    """The ring's stage events (every ``obs_every`` batches, then the
    flush) and the device stage's ``.put`` events, with their lineage."""
    path = str(tmp_path / "db")
    rs = np.random.RandomState(0)
    with lmdb_io.LmdbWriter(path) as w:
        for i in range(24):
            w.put(f"{i:08d}".encode(),
                  array_to_datum(rs.randint(0, 256, (3, 8, 8)).astype(np.uint8), i % 10))
    kw = dict(num_batches=10, workers=2, obs_every=4, name="feed.t")
    jr = jrecorder.set_recorder(jrecorder.Recorder(str(tmp_path / "j.jsonl")))
    try:
        with jpipe.ProcessPipeline(jrec.RecordShardSource(path, 4, shuffle=True, seed=1),
                                   **kw) as jp:
            for _ in jpipe.device_feed(jp):
                pass
            gc.collect()  # the JAX ring journals its last window when its stream is collected
    finally:
        jr.close()
        jrecorder.set_recorder(None)
    pr = precorder.set_recorder(precorder.Recorder(str(tmp_path / "p.jsonl")))
    try:
        with pipeline.ProcessPipeline(records.RecordShardSource(path, 4, shuffle=True,
                                                                seed=1), **kw) as pp:
            with pipeline.device_feed(pp, device="cpu") as feed:
                for _ in feed:
                    pass
    finally:
        pr.close()
        precorder.set_recorder(None)
    want, got = _events(tmp_path / "j.jsonl", "feed"), _events(tmp_path / "p.jsonl", "feed")
    assert got == want
    assert [e["name"] for e in got].count("feed.t") == 3  # 4 + 4 + the flush of 2
    assert [e["name"] for e in got].count("feed.t.put") == 2
    lin = [e["lineage"] for e in got if e["name"] == "feed.t"]
    assert [x["batches"] for x in lin] == [[0, 3], [4, 7], [8, 9]]
    assert lin[0]["source"].startswith("lmdb:db#batch=4")
