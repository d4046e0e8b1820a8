"""docs/API.md is import-verified: every `from <module> import <names>`
line inside its code fences must resolve against the installed package —
the doc can't drift from the API."""

import importlib
import pathlib
import re

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT = re.compile(
    r"^from\s+([\w.]+)\s+import\s+\(?([\w,\s]+?)\)?\s*(?:#.*)?$",
    re.MULTILINE)


def _fenced_code(md: str) -> str:
    return "\n".join(re.findall(r"```python\n(.*?)```", md, re.DOTALL))


def test_api_md_imports_resolve():
    code = _fenced_code((REPO / "docs" / "API.md").read_text())
    # multi-line parenthesized imports: join continuation lines first
    code = re.sub(r"import \(\n", "import (", code)
    code = re.sub(r",\n\s+", ", ", code)
    checked = 0
    for mod_name, names in _IMPORT.findall(code):
        if not mod_name.startswith(("hvqm4_jax", "tools")):
            continue
        mod = importlib.import_module(mod_name)
        for name in filter(None, (n.strip() for n in names.split(","))):
            assert hasattr(mod, name), f"{mod_name} has no symbol {name!r}"
            checked += 1
    assert checked >= 10, f"only {checked} imports found — parser broken?"


def test_api_md_dotted_references_resolve():
    """Prose references like `hvqm4_jax/session.py` must point at real
    files; FORMAT.md section references in code must point at sections
    that exist."""
    md = (REPO / "docs" / "API.md").read_text()
    for rel in set(re.findall(r"`(hvqm4_jax/[\w/]+\.py)`", md)):
        assert (REPO / rel).exists(), f"API.md references missing file {rel}"

    fmt = (REPO / "docs" / "FORMAT.md").read_text()
    # headings are "## N. Title" / "### N.M Title": exact section ids
    sections = {s.rstrip(".") for s in re.findall(
        r"^#+\s*(?:§)?([\d.]+)", fmt, re.MULTILINE)}
    import subprocess

    out = subprocess.run(
        ["grep", "-rhoE", r"FORMAT\.md §[0-9.]+", "hvqm4_jax", "tools",
         "oracle"],
        cwd=REPO, capture_output=True, text=True).stdout
    assert out.strip(), "no FORMAT.md § citations found — grep broken?"
    for ref in set(out.split("\n")) - {""}:
        sec = ref.split("§")[1].rstrip(".")
        # exact section id only: a cited §6.99 must not pass because §6
        # exists (that laxness would re-admit the §6.4/§6.5 drift class)
        assert sec in sections, (
            f"code cites FORMAT.md §{sec}, which does not exist "
            f"(sections: {sorted(sections)})")
