"""The port's IR half against the reference: spec digests, IR digests,
and the lowered ``FabricModule`` tables, all equal to the reference's
(both packages address one result store)."""
import json
import os

import numpy as np
import pytest

from repro.configs import cgra_amber as ref_amber
from repro.core.lowering import FabricModule as RefFabric
from repro.core.passes import PassManager as RefPassManager
from repro.core.passes import ir_digest as ref_ir_digest
from repro.core.spec import InterconnectSpec as RefSpec
from repro_torch import interop
from repro_torch.configs import cgra_amber
from repro_torch.core.lowering import FabricModule
from repro_torch.core.passes import PassManager, ir_digest
from repro_torch.core.spec import InterconnectSpec

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "spec_digests.json")

STOCK = {
    "stock_4x4": dict(width=4, height=4, num_tracks=2, io_ring=True,
                      reg_density=1.0),
    "stock_8x8": dict(width=8, height=8, num_tracks=5, io_ring=True,
                      reg_density=1.0),
}
SPECS = {**{k: InterconnectSpec(**v) for k, v in STOCK.items()},
         "amber_smoke": cgra_amber.smoke(), "amber_full": cgra_amber.FULL}
REF_SPECS = {**{k: RefSpec(**v) for k, v in STOCK.items()},
             "amber_smoke": ref_amber.smoke(), "amber_full": ref_amber.FULL}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_digest_matches_fixture_and_reference(name):
    with open(FIXTURE) as f:
        golden = json.load(f)
    assert SPECS[name].digest() == golden[name]["spec_digest"]
    assert SPECS[name].canonical_json() == REF_SPECS[name].canonical_json()


@pytest.mark.parametrize("name", ["stock_4x4", "stock_8x8", "amber_smoke"])
def test_ir_digest_matches_reference(name):
    with open(FIXTURE) as f:
        golden = json.load(f)
    ours = ir_digest(PassManager().run(SPECS[name]))
    assert ours == golden[name]["ir_digest"]
    assert ours == ref_ir_digest(RefPassManager().run(REF_SPECS[name]))


def _ref_tables(fab):
    """The reference fabric's tables by ``interop.TABLE_PATHS`` name."""
    out = {}
    for path in interop.TABLE_PATHS:
        head, _, leaf = path.rpartition(".")
        obj = fab.stream_tables() if head == "stream_tables" else (
            getattr(fab, head) if head else fab)
        out[path] = np.asarray(obj[leaf] if isinstance(obj, dict)
                               else getattr(obj, leaf))
    return out


@pytest.mark.parametrize("kw", [
    dict(width=4, height=4, num_tracks=2, io_ring=True, reg_density=1.0),
    dict(width=5, height=5, num_tracks=3, io_ring=True, mem_columns=(2,),
         sb_type="disjoint"),
], ids=["4x4_wilton", "5x5_disjoint_mem"])
def test_lowered_tables_equal_reference(kw):
    ref_fab = RefFabric(RefPassManager().run(RefSpec(**kw)))
    fab = FabricModule(PassManager().run(InterconnectSpec(**kw)),
                       device="cpu")
    interop.check_tables(fab, _ref_tables(ref_fab))
    assert fab.num_config == ref_fab.num_config
    assert [vars(s) for s in fab.config_slots] == \
        [vars(s) for s in ref_fab.config_slots]
    # a table that differs is named
    bad = _ref_tables(ref_fab)
    bad["fused_tables.pe_res_idx"] = bad["fused_tables.pe_res_idx"] + 1
    with pytest.raises(ValueError, match="pe_res_idx"):
        interop.check_tables(fab, bad)
