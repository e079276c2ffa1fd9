"""API documentation generator — the doccer equivalent (plain markdown
instead of the reference's lex/yacc doc compiler, SURVEY.md §2.5).

Walks eggshell_tpu's public modules and emits docs/api.md from module,
class, and function docstrings.

Usage: python tools/docgen.py [output.md]
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

# make the repo root importable regardless of invocation directory;
# importing the modules needs no accelerator
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

MODULES = [
    "eggshell_tpu",
    "eggshell_tpu.utils.config",
    "eggshell_tpu.ops.quaternion",
    "eggshell_tpu.ops.collision",
    "eggshell_tpu.ops.lcp",
    "eggshell_tpu.ops.lcp_direct",
    "eggshell_tpu.ops.lcp_kernel",
    "eggshell_tpu.ops.broadphase",
    "eggshell_tpu.ops.geometry2d",
    "eggshell_tpu.physics.scene",
    "eggshell_tpu.physics.contacts",
    "eggshell_tpu.physics.constraints",
    "eggshell_tpu.physics.stepper",
    "eggshell_tpu.physics.scenes",
    "eggshell_tpu.parallel.rollout",
    "eggshell_tpu.parallel.mesh",
    "eggshell_tpu.mpc.sampling",
    "eggshell_tpu.mpc.gradient",
    "eggshell_tpu.fem.shape",
    "eggshell_tpu.fem.mesher",
    "eggshell_tpu.fem.helmholtz",
    "eggshell_tpu.fem.fields",
    "eggshell_tpu.fem.antenna",
    "eggshell_tpu.fem.fdtd",
    "eggshell_tpu.opt.levenberg_marquardt",
    "eggshell_tpu.opt.nelder_mead",
    "eggshell_tpu.opt.random_search",
    "eggshell_tpu.opt.optimizer",
    "eggshell_tpu.models.api",
    "eggshell_tpu.viz.plot",
    "eggshell_tpu.viz.scene_view",
    "eggshell_tpu.viz.colormaps",
    "eggshell_tpu.viz.interactive",
    "eggshell_tpu.viz.camera",
    "eggshell_tpu.fem.block_tridiag",
    "eggshell_tpu.fem.sparse",
    "eggshell_tpu.ops.lcp_matrix_free",
    "eggshell_tpu.utils.trace",
    "eggshell_tpu.utils.precision",
    "eggshell_tpu.utils.compile_cache",
    "eggshell_tpu.utils.errors",
    "eggshell_tpu.utils.checkpoint",
    "eggshell_tpu.utils.mat_file",
    "eggshell_tpu.utils.step_parser",
    "eggshell_tpu.utils.dxf",
    "eggshell_tpu.utils.si_prefix",
    "eggshell_tpu.utils.hashing",
    "eggshell_tpu.utils.crash_handler",
    "eggshell_tpu.native",
    "eggshell_tpu.oracle.lcp_oracle",
    "eggshell_tpu.oracle.sim_oracle",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def render_module(name: str) -> str:
    mod = importlib.import_module(name)
    out = [f"## `{name}`\n"]
    doc = inspect.getdoc(mod)
    if doc:
        out.append(doc + "\n")
    for attr, obj in sorted(vars(mod).items()):
        if attr.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != name:
            continue
        doc = inspect.getdoc(obj)
        if inspect.isclass(obj):
            out.append(f"### class `{attr}`\n")
            if doc:
                out.append(doc + "\n")
            for m, fn in sorted(vars(obj).items()):
                if m.startswith("_") or not callable(fn):
                    continue
                mdoc = inspect.getdoc(fn)
                out.append(f"- **`{m}{_sig(fn)}`**"
                           + (f" — {mdoc.splitlines()[0]}" if mdoc else ""))
            out.append("")
        elif callable(obj):
            out.append(f"### `{attr}{_sig(obj)}`\n")
            if doc:
                out.append(doc + "\n")
    return "\n".join(out)


def main(out_path: str = "docs/api.md"):
    parts = [
        "# eggshell_tpu API reference\n",
        "_Generated by tools/docgen.py (the doccer-equivalent)._\n",
    ]
    for name in MODULES:
        try:
            parts.append(render_module(name))
        except Exception as e:  # keep generating
            parts.append(f"## `{name}`\n\n(render failed: {e})\n")
    with open(out_path, "w") as f:
        f.write("\n".join(parts))
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes)")


if __name__ == "__main__":
    main(*sys.argv[1:])
