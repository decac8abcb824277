"""The feeder process: writes a pool of gzip members into named pipes,
cycling, until a deadline, then closes them at a member boundary.

    python3 feeder.py SECONDS RESULT.json POOL_1 FIFO_1 [POOL_2 FIFO_2]

POOL_m is a file of gzip members and POOL_m.json its members' byte offsets
and read counts; the members go out in order, cycled. One thread writes
each pipe; the pipe's back-pressure sets the pace (a closed loop: the reader takes what it can, as from a file on
disk). The deadline runs from the first pipe's opening by the reader. With
two pipes (the mates of a pair) both stop after the same number of
members, so every pair is whole. Plain standard library: it starts fast and
shares no interpreter lock with the run it feeds.
"""

import json
import sys
import threading
import time


def main(argv):
    seconds = float(argv[0])
    result = argv[1]
    pairs = list(zip(argv[2::2], argv[3::2]))
    pools = []
    for pool, _ in pairs:
        meta = json.load(open(pool + ".json"))
        data = open(pool, "rb").read()
        off = meta["offsets"]
        pools.append(([data[off[k]:off[k + 1]] for k in range(len(off) - 1)],
                      meta["reads"]))
    lock = threading.Lock()
    opened = threading.Event()
    state = {"target": None, "started": [0] * len(pairs), "t_open": None,
             "error": None}

    def write(i):
        members, _ = pools[i]
        try:
            with open(pairs[i][1], "wb") as fh:
                with lock:
                    if state["t_open"] is None:
                        state["t_open"] = time.time()
                opened.set()
                while True:
                    with lock:
                        k = state["started"][i]
                        if state["target"] is not None and k >= state["target"]:
                            break
                        state["started"][i] = k + 1
                    fh.write(members[k % len(members)])
        except OSError as e:                  # the reader went away
            state["error"] = f"pipe {i + 1}: {e}"
            opened.set()

    threads = [threading.Thread(target=write, args=(i,), daemon=True)
               for i in range(len(pairs))]
    for t in threads:
        t.start()
    opened.wait()
    if state["t_open"] is not None:
        time.sleep(max(0.0, state["t_open"] + seconds - time.time()))
    with lock:
        state["target"] = max(state["started"])
    for t in threads:
        t.join()
    n = state["target"]
    reads = [sum(counts[k % len(counts)] for k in range(n))
             for _members, counts in pools]
    with open(result, "w") as fh:
        json.dump({"members": state["target"], "reads": reads,
                   "t_open": state["t_open"], "t_close": time.time(),
                   "error": state["error"]}, fh)
    return 0 if state["error"] is None else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
