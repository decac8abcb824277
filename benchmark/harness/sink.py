"""The sink process: drains the SAM the run writes into a named pipe.

    python3 sink.py FIFO SAMPLE_NAMES RESULT.json

Counts the records and the primary ones (flag without 0x100 and 0x800:
one a read), and keeps every record of the sampled reads' first
appearance (the pool cycles, so a name comes back; one read's records, or
one pair's, are written together). Plain standard library, in a process of
its own, so that it takes nothing from the measured process.
"""

import json
import sys


def main(argv):
    fifo, names_path, result = argv
    sample = set(open(names_path, "rb").read().split())
    kept: dict = {}
    done = set()
    records = primary = 0
    last = None
    with open(fifo, "rb", buffering=1 << 20) as fh:
        for line in fh:
            if line[:1] == b"@":
                continue
            t1 = line.find(b"\t")
            t2 = line.find(b"\t", t1 + 1)
            name = line[:t1]
            records += 1
            if not int(line[t1 + 1:t2]) & 0x900:
                primary += 1
            if name != last:
                if last in kept:
                    done.add(last)
                last = name
            if name in sample and name not in done:
                kept.setdefault(name, []).append(line.decode())
    with open(result, "w") as fh:
        json.dump({"records": records, "primary": primary,
                   "kept": {k.decode(): v for k, v in kept.items()}}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
