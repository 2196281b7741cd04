"""PyTorch port — the kernels' build: a library is named by a hash of its
source, the ``*.cuh`` headers beside it and the nvcc flags, so an edited
header rebuilds every kernel that may include it (checked on copies of the
sources in a temporary directory; nothing is compiled here)."""
import shutil

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_attention as tpa


def test_library_path_follows_source_and_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(tpa.SOURCE.parent, csrc)
    sources = [csrc / tpa.SOURCE.name, csrc / tfa.SOURCE.name]
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the attention kernels share a header"
    before = [kbuild.library_path(s) for s in sources]
    assert before == [kbuild.library_path(s) for s in sources]  # stable
    assert before[0] != before[1]
    assert all(p.parent == kbuild.BUILD_DIR for p in before)
    # one byte more in a header renames every library beside it
    headers[0].write_bytes(headers[0].read_bytes() + b"\n")
    after = [kbuild.library_path(s) for s in sources]
    assert all(a != b for a, b in zip(after, before))
    # and so does an edit of the source itself, for that source only
    sources[0].write_bytes(sources[0].read_bytes() + b"\n")
    again = [kbuild.library_path(s) for s in sources]
    assert again[0] != after[0] and again[1] == after[1]
    # a new header counts too
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kbuild.library_path(sources[1]) != again[1]
