#!/usr/bin/env python3
"""TFSF scattered-field leakage of the JAX reference and the PyTorch port
on the CPU, at a small size.

Runs ``Examples/vacuum3D_tfsf.txt`` at ``--same-size 48`` for
its 150 steps through the reference's jnp step (``fdtd3d_tpu``, JAX on
the CPU) and through the port's plain and packed steps (``fdtd3d_torch``
on the CPU), and prints ``fdtd3d_torch.diag.tfsf_leakage`` of each: max
|E| outside the total-field box over max |E| inside. chip_smoke.py
holds the card's run at 256^3 to within 10x of the reference's number.

    JAX_PLATFORMS=cpu python3 scripts/tfsf_leakage.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
SIZE = 48


def main() -> int:
    extra = ["--same-size", str(SIZE)]

    import numpy as np

    from fdtd3d_torch import cli as tcli
    from fdtd3d_torch.diag import tfsf_leakage
    from fdtd3d_torch.sim import Simulation as TSim
    from fdtd3d_tpu import cli as rcli
    from fdtd3d_tpu.sim import Simulation as RSim

    def cfg(cli_mod, **kw):
        p = cli_mod.build_parser()
        c = cli_mod.args_to_config(
            p.parse_args(cli_mod.read_cmd_file(EXAMPLE) + extra))
        for k, v in kw.items():
            setattr(c, k, v)
        return c

    out = {"size": SIZE}
    ref = RSim(cfg(rcli, use_pallas=False))
    ref.run()
    setup = ref.static.tfsf_setup
    out["reference_jnp"] = tfsf_leakage(
        {c: np.asarray(v) for c, v in ref.fields().items()},
        setup.lo, setup.hi)
    for label, flag in (("port_plain", False), ("port_packed_plain", True)):
        sim = TSim(cfg(tcli, use_pallas=flag), device="cpu")
        sim.run()
        out[label] = tfsf_leakage(sim.fields(), setup.lo, setup.hi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
