"""chip_smoke.py leaves no process running when it ends: a training CLI's
loader (4 spawned workers, and multiprocessing's resource tracker behind
its queues) and a stray child, both started in a process of their own,
are stopped by ``stop_children``, and nothing of that process's session
outlives it."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

# Six test workers share the CPU: cap torch's intra-op threads.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

CHILD = textwrap.dedent("""
    import json, subprocess, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    import chip_smoke
    from mhada_tpu_torch.data.coco_wikiart import make_loader

    if __name__ == "__main__":
        loader = make_loader([(np.zeros((2, 2, 3), np.float32),)] * 8, 2,
                             seed=0)
        for batch in loader:   # as train_epochs' --steps-per-epoch does
            break
        del batch
        stray = subprocess.Popen(["sleep", "60"])
        found = chip_smoke.stop_children()
        print(json.dumps({"found": found, "left": chip_smoke._children(),
                          "stray": stray.pid}))
""")


def _session(sid: int) -> list[str]:
    """The running processes of session ``sid``."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            out.append(pid)
    return out


def test_stop_children_leaves_nothing_running(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    proc = subprocess.Popen([sys.executable, str(script), str(ROOT)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    got = json.loads(out.splitlines()[-1])
    assert got["left"] == {}
    assert any(f.startswith(f"{got['stray']} sleep 60") for f in got["found"])
    assert any("resource_tracker" in f for f in got["found"]), got["found"]
    assert "leaked" not in err, err
    assert _session(proc.pid) == []
