"""Quickstart on the PyTorch/CUDA port (counterpart of quickstart.py):
the Canal front door in five steps — describe an interconnect as a
frozen spec, compile it through the pass pipeline, place and route an
application, generate the bitstream, and emulate.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Without ``--device`` it runs on the CUDA card, the fabric through the
hand-written kernels.
"""
import argparse

import numpy as np

import canal_torch
from repro_torch.core.pnr.app import app_pointwise
from repro_torch.device import on_card


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--size", type=int, default=6,
                    help="fabric width and height")
    ap.add_argument("--tracks", type=int, default=4)
    args = ap.parse_args(argv)

    # 1. declare the design point: frozen, hashable, JSON-round-trippable
    spec = canal_torch.InterconnectSpec(width=args.size, height=args.size,
                                        num_tracks=args.tracks,
                                        sb_type="wilton", io_ring=True,
                                        reg_density=1.0)
    print(f"spec: digest {spec.digest()[:16]}")

    # 2. compile: named IR passes -> CompiledFabric handle
    fab = canal_torch.compile(spec, device=args.device,
                              use_kernels=on_card(args.device))
    ic = fab.interconnect
    print(f"interconnect: {ic.num_nodes()} IR nodes, {ic.num_edges()} "
          f"edges via passes {[e['pass'] for e in fab.pass_log]}")
    print(f"fabric: {fab.fabric().num_config} config registers, "
          f"area {fab.area()['sb_area']:.0f} um2 (SB)")

    # 3. an application: out = ((in + 1) + 2) + 3
    app = app_pointwise(3)
    result = fab.place_and_route(app, alphas=(2.0,), sa_steps=60)
    assert result.success, result.error
    print(f"PnR: crit path {result.timing['critical_path_ns']:.2f} ns, "
          f"wirelength {result.wirelength}, "
          f"{result.route_iterations} routing iterations "
          f"(router: {result.route_strategy})")

    # 4. bitstream
    words = fab.bitstream(result)
    print(f"bitstream: {len(words)} config words")

    # 5. emulate (inputs keyed by app instance name or IO tile coord)
    cycles = 12
    x = np.arange(50, 50 + cycles).astype(np.int32)
    outs = fab.emulate(result, {"in0": x}, cycles=cycles)
    y = outs[result.placement["out0"]]
    lat = np.nonzero(y)[0][0]
    print(f"emulation: in={x[:6]} -> out={y[lat:lat + 6]} "
          f"(latency {lat} cycles)")
    assert list(y[lat:lat + 6]) == list(x[:6] + 6)
    print("OK")


if __name__ == "__main__":
    main()
