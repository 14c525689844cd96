"""Start daemons under CPU load and look each one up at once by its mark.

    python3 scripts/exec_race.py [--daemons 150] [--burners 8]

Each daemon is `sleep 300`, started through `control/util.start_daemon`
on a `LoopbackRemote` (``setsid nohup env sleep 300``) with `chip_smoke`'s
mark in the environment, and looked up with `chip_smoke.marked_pids` and
`chip_smoke._cmdline` right after `start_daemon` returns, while
`--burners` processes keep every core busy.  A daemon still between two
``execve`` calls reads an empty ``/proc/<pid>/environ`` and ``cmdline``;
the script prints how many lookups missed the daemon or its command line.
Every daemon is killed after its lookup.  Runs on the CPU; needs no card.
"""

import argparse
import multiprocessing as mp
import os
import signal
import sys
import tempfile
import uuid

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from jepsen_tpu_torch.control import api as control  # noqa: E402
from jepsen_tpu_torch.control import util as cu  # noqa: E402
from jepsen_tpu_torch.control.local import LoopbackRemote  # noqa: E402


def burn(stop) -> None:
    while not stop.is_set():
        pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--daemons", type=int, default=150)
    p.add_argument("--burners", type=int, default=os.cpu_count() or 4)
    opts = p.parse_args(argv)
    stop = mp.Event()
    burners = [mp.Process(target=burn, args=(stop,))
               for _ in range(opts.burners)]
    for b in burners:
        b.start()
    missed = no_cmdline = 0
    prev = os.environ.get(cs.TAG_VAR)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for i in range(opts.daemons):
                tag = f"exec-race-{uuid.uuid4().hex}"
                os.environ[cs.TAG_VAR] = tag
                base = os.path.join(tmp, str(i))
                r = LoopbackRemote(base_dir=base)
                with control.with_session("n1", r.connect("n1")):
                    cu.start_daemon("sleep", "300", logfile="d.log",
                                    pidfile="d.pid")
                with open(os.path.join(base, "n1", "d.pid")) as f:
                    pid = int(f.read())
                try:
                    if pid not in cs.marked_pids(tag):
                        missed += 1
                    elif "sleep 300" not in cs._cmdline(pid):
                        no_cmdline += 1
                finally:
                    os.kill(pid, signal.SIGKILL)
                    try:
                        os.waitpid(pid, 0)
                    except ChildProcessError:
                        pass  # the daemon is not our child: init reaps it
    finally:
        stop.set()
        for b in burners:
            b.join()
        if prev is None:
            os.environ.pop(cs.TAG_VAR, None)
        else:
            os.environ[cs.TAG_VAR] = prev
    print(f"daemons {opts.daemons}, burners {opts.burners}: environ lookups "
          f"missed {missed}, command lines missed {no_cmdline}")
    return 1 if missed or no_cmdline else 0


if __name__ == "__main__":
    sys.exit(main())
