"""``core/verify.py`` in the port against the reference's: the structural
check and the exhaustive configuration sweep count the same connections,
raise on the same corrupted tables with the same message, and the
port's chunked sweep answers the same for every chunk size. Also the
``scope="lowered"`` rules, ``CompiledFabric.verify()`` and
``python -m canal_torch.lint --lowered``, all on the CPU."""
import copy
import functools
import io
import json

import numpy as np
import pytest

from repro.core import verify as ref_verify
from repro.core.lowering import FabricModule as RefFabric
from repro.core.passes import PassManager as RefPassManager
from repro.core.spec import InterconnectSpec as RefSpec
import canal_torch
from repro_torch.core import verify
from repro_torch.core.analysis.lint import run as lint_run
from repro_torch.core.lowering import FabricModule
from repro_torch.core.passes import PassManager
from repro_torch.core.spec import InterconnectSpec

SPECS = {
    "4x4": dict(width=4, height=4, num_tracks=2, io_ring=True,
                sb_type="wilton", reg_density=1.0),
    "6x6_disjoint": dict(width=6, height=6, num_tracks=3, io_ring=True,
                         sb_type="disjoint", reg_density=0.5),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    ref_ic = RefPassManager().run(RefSpec(**SPECS[name]))
    ic = PassManager().run(InterconnectSpec(**SPECS[name]))
    return (ref_ic, RefFabric(ref_ic),
            ic, FabricModule(ic, device="cpu", use_kernels=True))


def _corrupt(fab, kind):
    """A copy of ``fab`` with one table broken (the copy shares nothing
    mutable with the original)."""
    bad = copy.copy(fab)
    bad.arrays = copy.deepcopy(fab.arrays)
    bad.config_slots = list(fab.config_slots)
    a = bad.arrays
    slots = np.nonzero(a.config_slot >= 0)[0]
    if kind == "config_slot_swap":
        i, j = slots[3], slots[11]
        a.config_slot[i], a.config_slot[j] = a.config_slot[j], \
            a.config_slot[i]
    elif kind == "src_entry":
        i = slots[5]
        a.src[i, 1] = (a.src[i, 1] + 1) % a.num_nodes
    elif kind == "config_slot_unset":
        a.config_slot[slots[-1]] = -1
    elif kind == "fanin_count":
        a.fanin_count[slots[7]] -= 1
    if hasattr(bad, "_on_device"):
        bad._on_device = {}
    return bad


@pytest.mark.parametrize("name", sorted(SPECS))
def test_counts_match_reference(name):
    ref_ic, ref_fab, ic, fab = _pair(name)
    ref_verify.verify_structural(ref_ic, ref_fab)
    verify.verify_structural(ic, fab)
    want = ref_verify.config_sweep(ref_fab)
    assert want == sum(s.fanin for s in fab.config_slots) > 0
    assert verify.config_sweep(fab) == want
    assert verify.verify(ic, fab) == ref_verify.verify(ref_ic, ref_fab)


@pytest.mark.parametrize("batch", [1, 7, 512, 100000])
def test_chunked_sweep_any_batch(batch):
    """Chunks of 1, of a size that leaves a ragged last chunk, and one
    chunk for everything all give the reference's count."""
    _, ref_fab, _, fab = _pair("4x4")
    assert verify.config_sweep(fab, batch=batch) == \
        ref_verify.config_sweep(ref_fab)


def _outcome(fn):
    """The count ``fn`` returns, or the message it raises."""
    try:
        return fn()
    except AssertionError as e:
        return f"raised: {e}"


@pytest.mark.parametrize("kind", ["config_slot_swap", "fanin_count",
                                  "config_slot_unset", "src_entry"])
@pytest.mark.parametrize("batch", [13, 2048])
def test_corrupted_tables_like_reference(kind, batch):
    """Swapped or unset config slots and a shrunk fan-in count make the
    sweep fail, with the reference's message; a changed ``src`` entry
    moves the expected value with it, so the sweep passes in both (the
    structural check catches it, below)."""
    _, ref_fab, _, fab = _pair("4x4")
    want = _outcome(lambda: ref_verify.config_sweep(_corrupt(ref_fab, kind)))
    got = _outcome(lambda: verify.config_sweep(_corrupt(fab, kind),
                                               batch=batch))
    assert got == want
    assert isinstance(want, int) == (kind == "src_entry")
    # the plain branch (use_kernels=False) agrees too
    plain = _corrupt(fab, kind)
    plain.use_kernels = False
    assert _outcome(lambda: verify.config_sweep(plain, batch=batch)) == want


def test_structural_mismatch_raises_like_reference():
    ref_ic, ref_fab, ic, fab = _pair("4x4")
    with pytest.raises(AssertionError) as want:
        ref_verify.verify_structural(ref_ic, _corrupt(ref_fab, "src_entry"))
    with pytest.raises(AssertionError) as got:
        verify.verify_structural(ic, _corrupt(fab, "src_entry"))
    assert str(got.value) == str(want.value)


def test_compiled_fabric_verify_and_lowered_rules():
    fab = canal_torch.compile(InterconnectSpec(**SPECS["4x4"]),
                              device="cpu", use_kernels=True,
                              analyze="off")
    report = fab.verify()
    assert report.ok()
    assert set(report.rules_run) == {"structural-equivalence",
                                     "config-sweep"}
    n = sum(s.fanin for s in fab.fabric().config_slots)
    assert [d.message for d in report.diagnostics] == [
        f"{n} mux connection(s) verified"]
    direct = canal_torch.analyze(fab.interconnect, scope="lowered",
                                 fabric=fab.fabric(use_kernels=False))
    assert direct.to_dict() == report.to_dict()


def test_lint_lowered_cli(tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(InterconnectSpec(**SPECS["4x4"]).to_json())
    out = io.StringIO()
    rc = lint_run([str(path), "--lowered", "--device", "cpu",
                   "--format", "json"], out=out)
    assert rc == 0
    doc = json.loads(out.getvalue())
    rep = doc["targets"][str(path)]
    assert "config-sweep" in rep["rules_run"]
    assert rep["clean"]
