"""The port's command line with ``--distributed`` on the CPU: without
torchrun's environment (one process: the single run, as without the flag)
and at world size 2 over gloo (``shard/launch.py::launch_command`` sets
the environment): the ``[distributed]`` line, every rank's pose equal to
the single run's, rank 0 alone writing the output."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from ghicp_tpu_torch.cli.main import main
from ghicp_tpu_torch.io import write_cloud
from ghicp_tpu_torch.io.synthetic import structured_scene
from ghicp_tpu_torch.shard.launch import launch_command

torch.set_num_threads(1)
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_dist")
    rng = np.random.default_rng(0)
    pts = structured_scene(rng, 6000, extent=8.0)
    th = np.deg2rad(6.0)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    t = np.float32([0.6, -0.4, 0.1])
    src = ((pts - t) @ R + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    sp, tp = str(d / "s.ply"), str(d / "t.ply")
    write_cloud(sp, src)
    write_cloud(tp, tgt)
    return d, sp, tp


def _args(files, out_dir):
    _, sp, tp = files
    return [tp, sp, str(out_dir / "out.ply"), "N", "R", "0.15", "0.5", "1.0",
            "1.1", "0.1", "6", "0.9", "0", "--max-iterations", "40",
            "--device", "cpu", "--json"]


@pytest.fixture(scope="module")
def single(files):
    """The run with ``--distributed`` and no environment: (rc, output)."""
    from contextlib import redirect_stdout
    from io import StringIO
    saved = {k: os.environ.pop(k) for k in ENV if k in os.environ}
    out_dir = files[0] / "one"
    out_dir.mkdir()
    buf = StringIO()
    try:
        with redirect_stdout(buf):
            rc = main(_args(files, out_dir) + ["--distributed"])
    finally:
        os.environ.update(saved)
    return rc, buf.getvalue()


def test_without_the_environment_one_process(single):
    rc, out = single
    assert rc == 0 and _json(out)["success"]
    assert "[distributed] 1 process(es), 1 device(s)" in out.splitlines()
    assert "[io] wrote" in out
    assert not torch.distributed.is_initialized()


def test_two_ranks_over_gloo(files, single):
    out_dir = files[0] / "two"
    out_dir.mkdir()
    outs = launch_command([sys.executable, "-m", "ghicp_tpu_torch.cli.main"]
                          + _args(files, out_dir) + ["--distributed"], 2,
                          timeout=600)
    for out in outs:
        lines = out.splitlines()
        assert "[distributed] 2 process(es), 1 device(s)" in lines
        assert lines.index("[distributed] 2 process(es), 1 device(s)") < \
            min(i for i, ln in enumerate(lines) if ln.startswith("[io]"))
        got = _json(out)
        assert got["success"]
        assert got["transform"] == _json(single[1])["transform"]
    assert "[io] wrote" in outs[0] and "[io] wrote" not in outs[1]
    assert os.listdir(out_dir) == ["out.ply"]
