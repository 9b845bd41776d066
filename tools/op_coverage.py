"""How much of the JAX package's op registry the PyTorch port registers.

    JAX_PLATFORMS=cpu python tools/op_coverage.py [--json]

Imports both packages (``paddle_tpu`` registers every op it lowers,
``paddle_tpu_torch`` the ops its ported paths run) and prints how many of
the JAX registry's forward op types (those with a lowering; the ``*_grad``
ops follow their forward) the port registers, then the ones it does not,
one per line.  ``--json`` prints one JSON object instead: ``jax_count``,
``ported_count``, ``ported``, ``missing``, and ``extra`` (port ops JAX
does not have; always empty for a faithful port).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _forward_ops(ops) -> set:
    return {t for t, d in ops.items()
            if d.lower is not None and not t.endswith("_grad")}


def coverage() -> dict:
    import paddle_tpu  # noqa: F401  (registers every JAX lowering)
    import paddle_tpu.ops.registry as jreg
    import paddle_tpu_torch.fluid  # noqa: F401  (registers the port's)
    import paddle_tpu_torch.ops.registry as treg

    jax_ops, port_ops = _forward_ops(jreg.OPS), _forward_ops(treg.OPS)
    ported = sorted(jax_ops & port_ops)
    return {"jax_count": len(jax_ops), "ported_count": len(ported),
            "ported": ported, "missing": sorted(jax_ops - port_ops),
            "extra": sorted(port_ops - jax_ops)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rep = coverage()
    if args.json:
        print(json.dumps(rep))
        return
    print(f"the port registers {rep['ported_count']} of the JAX package's "
          f"{rep['jax_count']} forward op types "
          f"({100.0 * rep['ported_count'] / rep['jax_count']:.1f}%)")
    if rep["extra"]:
        print("port ops JAX does not have: " + ", ".join(rep["extra"]))
    print(f"missing ({len(rep['missing'])}):")
    for t in rep["missing"]:
        print("  " + t)


if __name__ == "__main__":
    main()
