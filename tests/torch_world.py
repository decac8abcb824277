"""Start and join a gloo world of worker processes on the CPU for the
port's mesh and multi-host tests. Each world initializes through a file
under the test's own temporary directory (no TCP port to collide with
another xdist worker) and runs one torch thread a rank. When a rank fails
or the world outlives its timeout, every rank is killed, so a hung or
stranded rank fails its test instead of the suite's clock."""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class World:
    """n ranks of tests/<script>: argv RANK N file://<tmp>/init *args;
    each rank's output goes to <tmp>/rank<r>.log."""

    def __init__(self, script: str, n: int, tmp, args):
        tmp = str(tmp)
        init = os.path.join(tmp, "init")
        if os.path.exists(init):
            os.remove(init)
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu")
        env.pop("PYTEST_CURRENT_TEST", None)
        self.logs = [os.path.join(tmp, f"rank{r}.log") for r in range(n)]
        self.procs = []
        for r in range(n):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "tests", script),
                     str(r), str(n), f"file://{init}", *map(str, args)],
                    stdout=log, stderr=subprocess.STDOUT, env=env))

    def join(self, timeout: float) -> list[str]:
        """Every rank's output once all exited 0; AssertionError (every
        rank killed) when one failed or `timeout` seconds passed."""
        deadline = time.monotonic() + timeout
        why = None
        while why is None:
            rcs = [p.poll() for p in self.procs]
            if all(rc == 0 for rc in rcs):
                break
            if any(rc not in (None, 0) for rc in rcs):
                why = f"a rank failed (return codes {rcs})"
            elif time.monotonic() > deadline:
                why = f"the world ran past {timeout} s"
            else:
                time.sleep(0.2)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for path in self.logs:
            with open(path) as fh:
                outs.append(fh.read())
        assert why is None, why + "\n" + "\n".join(
            f"--- rank {r}\n{o[-4000:]}" for r, o in enumerate(outs))
        return outs
