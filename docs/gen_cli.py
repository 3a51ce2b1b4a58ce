"""Regenerate docs/CLI.md from the argparse tree.

Usage:  JAX_PLATFORMS=cpu python docs/gen_cli.py
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

def _subcommands() -> list:
    """Enumerate subcommands from the live argparse tree so new ones
    can't fall out of the doc (info/similarity once did)."""
    from findkmer_tpu.cli import build_parser

    for action in build_parser()._subparsers._group_actions:
        return list(action.choices)
    raise SystemExit("no subparsers found")

HEADER = """# findkmer CLI reference

Generated from the argparse tree (`python -m findkmer_tpu.cli <cmd> \
--help` is always authoritative).
"""


def main() -> int:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    env["PYTHONPATH"] = repo
    sys.path.insert(0, repo)
    out = io.StringIO()
    out.write(HEADER)
    for cmd in _subcommands():
        r = subprocess.run(
            [sys.executable, "-m", "findkmer_tpu.cli", cmd, "--help"],
            capture_output=True, text=True, env=env, cwd=repo,
        )
        if r.returncode != 0:
            raise SystemExit(f"{cmd} --help failed: {r.stderr}")
        help_text = r.stdout.replace("gen_cli.py", "findkmer").rstrip()
        out.write(f"\n## `findkmer {cmd}`\n\n```text\n{help_text}\n```\n")
    path = os.path.join(repo, "docs", "CLI.md")
    with open(path, "w") as f:
        f.write(out.getvalue())
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
