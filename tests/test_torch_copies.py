"""Every port file that carries a `Verbatim copy of <path>` header equals its
JAX source after that header (the port imports nothing of the JAX package,
so it keeps copies). The files are found by their headers, so a new copy is
held too."""
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "scoreperformer_tpu_torch"
HEADER = re.compile(r"^(?:#|//) Verbatim copy of (scoreperformer_tpu/\S+); the port imports nothing of the JAX package\.\n$")


def copies():
    found = []
    for path in sorted(PORT.rglob("*")):
        if not path.is_file() or path.suffix not in (".py", ".cpp", ".h", ".hpp", ".cc"):
            continue
        with path.open(encoding="utf-8") as f:
            first = f.readline()
        if "Verbatim copy of" in first:
            found.append(path)
    return found


COPIES = copies()


def test_every_copy_is_found():
    """The port's 36 copies (ROADMAP's list) are all found by the glob."""
    assert len(COPIES) >= 36


@pytest.mark.parametrize("path", COPIES, ids=[str(p.relative_to(PORT)) for p in COPIES])
def test_the_copies_are_verbatim(path):
    lines = path.read_text(encoding="utf-8").splitlines(keepends=True)
    header = HEADER.match(lines[0])
    assert header is not None, f"{path}: header {lines[0]!r}"
    source = ROOT / header.group(1)
    assert source.relative_to(ROOT / "scoreperformer_tpu") == path.relative_to(PORT)
    assert "".join(lines[1:]) == source.read_text(encoding="utf-8")
