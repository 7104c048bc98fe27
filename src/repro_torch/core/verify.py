"""Structural verification and configuration sweep (§3.3, last paragraph),
in PyTorch (counterpart of repro/core/verify.py).

The paper verifies generated RTL by (1) comparing hardware connectivity
against the IR and (2) an exhaustive configuration sweep exercising every
possible connection. We do the same against the lowered fabric:

* ``verify_structural`` — the fabric's gather tables must reproduce the IR
  fan-in lists exactly (order included: select-bit semantics).
* ``config_sweep`` — for every multi-input mux node and every one of its
  inputs, drive a distinguishing value pattern through the fabric with only
  that select programmed and check the mux output follows the selected
  input after one sweep (the hardware "every possible connection" test).

The reference evaluates every (mux, input) case in one vmap, which at the
Amber FULL size (214,080 cases x 86,288 nodes) is a ~74 GB int32 value
matrix; here the same checks run in chunks of ``batch`` cases, each one
``fabric_sweep_batch`` launch on the fabric's device with
``use_kernels``. Same count, same failures, same message.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .graph import Interconnect
from .lowering import FabricModule


def verify_structural(ic: Interconnect, fabric: FabricModule) -> None:
    """Raise AssertionError if the lowered fabric's connectivity deviates
    from the IR (the paper's RTL-vs-IR connectivity check)."""
    ir_conn = ic.connectivity()
    hw_conn = fabric.structural_connectivity()
    if set(ir_conn) != set(hw_conn):
        missing = set(ir_conn) ^ set(hw_conn)
        raise AssertionError(f"node set mismatch, e.g. {list(missing)[:4]}")
    for key, fan_in in ir_conn.items():
        if fan_in != hw_conn[key]:
            raise AssertionError(
                f"fan-in mismatch at {key}: IR={fan_in} HW={hw_conn[key]}")


def sweep_cases(fabric: FabricModule) -> Tuple[np.ndarray, np.ndarray]:
    """Every (mux, input) case of :func:`config_sweep`, slot-major:
    (config slot index, select value) as two int64 arrays."""
    fanins = np.array([slot.fanin for slot in fabric.config_slots],
                      np.int64)
    slot_ids = np.repeat(np.arange(len(fanins)), fanins)
    sels = np.arange(len(slot_ids)) - np.repeat(np.cumsum(fanins) - fanins,
                                                fanins)
    return slot_ids, sels


def case_selects(fabric: FabricModule, slot_ids: np.ndarray,
                 sels: np.ndarray) -> torch.Tensor:
    """(B, N) mux selects on the fabric's device for B cases: each case
    programs only its own slot (zeros elsewhere), through the fabric's
    own config -> select map."""
    dev = fabric.device
    b = len(slot_ids)
    config = torch.zeros((b, fabric.arrays.num_config), dtype=torch.int32,
                         device=dev)
    config[torch.arange(b, device=dev),
           torch.as_tensor(slot_ids, device=dev)] = \
        torch.as_tensor(sels.astype(np.int32), device=dev)
    return fabric._selects(config)


def config_sweep(fabric: FabricModule, batch: int = 2048,
                 seed: int = 0) -> int:
    """Exhaustively exercise every (mux, input) connection.

    For each configurable node ``n`` and each input index ``s``, build a
    config selecting ``s`` at ``n`` (zeros elsewhere) and check after one
    sweep: value(n) == value(input_s). Values are randomized per node so a
    wrong connection is detected w.h.p. Evaluated ``batch`` cases at a
    time on the fabric's device. Returns the number of connections
    checked.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    a = fabric.arrays
    rng = np.random.default_rng(seed)
    # deterministic distinct per-node values (mod 16-bit)
    node_vals = rng.integers(1, 1 << 15,
                             size=a.num_nodes + 1).astype(np.int32)
    node_vals[-1] = 0

    slot_ids, sels = sweep_cases(fabric)
    if not len(slot_ids):
        return 0
    slot_node = np.array([s.node_id for s in fabric.config_slots], np.int64)
    nodes = slot_node[slot_ids]
    # the expected value of every case: the selected input's own value
    expect = node_vals[a.src[nodes, sels]]

    dev = fabric.device
    m = min(batch, len(slot_ids))
    vals = torch.as_tensor(node_vals, device=dev).expand(
        m, a.num_nodes + 1).contiguous()
    ok = np.empty(len(slot_ids), bool)
    for lo in range(0, len(slot_ids), m):
        hi = min(lo + m, len(slot_ids))
        sel = case_selects(fabric, slot_ids[lo:hi], sels[lo:hi])
        new_vals = fabric._gather_batch(vals[:hi - lo], sel)
        got = new_vals[torch.arange(hi - lo, device=dev),
                       torch.as_tensor(nodes[lo:hi], device=dev)]
        ok[lo:hi] = (got == torch.as_tensor(expect[lo:hi], device=dev)) \
            .cpu().numpy()
    bad = np.nonzero(~ok)[0]
    if len(bad):
        slot = fabric.config_slots[slot_ids[bad[0]]]
        raise AssertionError(
            f"config sweep failed at node {fabric.nodes[slot.node_id]} "
            f"select {sels[bad[0]]} (+{len(bad) - 1} more)")
    return len(slot_ids)


def verify(ic: Interconnect, fabric: FabricModule) -> Dict[str, int]:
    verify_structural(ic, fabric)
    checked = config_sweep(fabric)
    return {"nodes": fabric.arrays.num_nodes,
            "configs": fabric.num_config,
            "connections_checked": checked}
