"""The CUDA build's source lists (``ops/_build.SOURCES``): each library's
hash must cover every header its ``.cu`` files include, directly or through
another header, or an edited header is served from a stale build. Reads the
sources only; nothing is compiled."""

import os
import re

import pytest

from network_distributed_pytorch_tpu_torch.ops import _build

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _includes(name):
    """The quoted includes of ``csrc/name``, and theirs, transitively."""
    seen, todo = set(), [name]
    while todo:
        with open(os.path.join(_build.CSRC, todo.pop())) as f:
            for inc in _INCLUDE.findall(f.read()):
                if inc not in seen:
                    seen.add(inc)
                    todo.append(inc)
    return seen


@pytest.mark.parametrize("library", sorted(_build.SOURCES))
def test_library_sources_cover_every_included_header(library):
    sources = _build.SOURCES[library]
    for src in sources:
        assert os.path.isfile(os.path.join(_build.CSRC, src)), src
    for cu in (s for s in sources if s.endswith(".cu")):
        missing = _includes(cu) - set(sources)
        assert not missing, f"{library}: {cu} includes {sorted(missing)}, which SOURCES does not list"


def test_every_kernel_source_is_built():
    """Every file under ``csrc/`` enters some library, so no kernel source
    lies outside the build."""
    listed = {src for sources in _build.SOURCES.values() for src in sources}
    assert set(os.listdir(_build.CSRC)) <= listed
