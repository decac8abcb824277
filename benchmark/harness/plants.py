"""The control and the faults of the correctness check, put in the
program's place by `run.py --plant NAME` (never by the driver's runs).

  int16, int8, int4  the control: the DP reference (reference/dp.py) in the
                     kernel's place, computed in saturating integers of
                     that width on the kernel's device
  skip_dp            a step that returns its state unchanged: the DP
                     returns its starting floor (every read clipped away)
                     and fills nothing
  drop_half          half of the batch left out: the read layer hands on
                     the first half of every batch
  alter_pos          an answer altered where it is produced: every record
                     the SAM writer writes is placed one base to the right
  double_out         work counted twice: every run of whole records the SAM
                     writer writes goes out twice (a batch emitted again)
  alter_anchor       an answer altered where it is produced: each valid
                     anchor-scan match moves 16 bases on
"""

from __future__ import annotations

import importlib

PLANTS = ("int16", "int8", "int4", "skip_dp", "drop_half", "alter_pos",
          "double_out", "alter_anchor")
PKG = "hisat2_tpu_torch"


def dp(plant, orig):
    """The DP the run calls."""
    if plant in ("int16", "int8", "int4"):
        from reference.dp import dp_fill
        bits = int(plant[3:])

        def control(rd, pen, rdlens, ref, scp_cum, *, ov=None, plan=None,
                    **consts):
            return dp_fill(rd, pen, rdlens, ref, scp_cum, ov=ov, bits=bits,
                           **consts)
        return control
    if plant == "skip_dp":
        def skip(rd, pen, rdlens, ref, scp_cum, *, ov=None, plan=None,
                 **consts):
            return (-scp_cum[:, -1]).contiguous()
        return skip
    return orig


def anchor(plant, orig):
    if plant != "alter_anchor":
        return orig

    def alter(*a, **k):
        kv, mpos = orig(*a, **k)
        return kv, mpos + 16 * kv.to(mpos.dtype)
    return alter


def _shift(text):
    """Every SAM record of text one base to the right."""
    lines = text.split("\n")
    for i, ln in enumerate(lines):
        f = ln.split("\t")
        if len(f) > 3 and not ln.startswith("@") and f[3].isdigit() \
                and f[3] != "0":
            f[3] = str(int(f[3]) + 1)
            lines[i] = "\t".join(f)
    return "\n".join(lines)


def _twice(text):
    """Whole records twice over."""
    return text + text if text.endswith("\n") else text


class _EditedOut:
    """A text sink that edits what the SAM writer writes through it."""

    def __init__(self, out, edit):
        self.out = out
        self.edit = edit

    def write(self, text):
        return self.out.write(self.edit(text))

    def writelines(self, lines):
        for ln in lines:
            self.write(ln)

    def __getattr__(self, name):
        return getattr(self.out, name)


def install_io(plant, probes) -> None:
    """The faults outside the kernels."""
    if plant == "drop_half":
        mod = importlib.import_module(PKG + ".io.reads")
        orig = mod.batchify

        def batchify(reads, *a, **k):
            return orig(list(reads)[:max(1, len(reads) // 2)], *a, **k)
        probes._set(mod, "batchify", batchify)
    elif plant in ("alter_pos", "double_out"):
        edit = _shift if plant == "alter_pos" else _twice
        mod = importlib.import_module(PKG + ".io.sam")
        base = mod.SamWriter

        class EditedWriter(base):
            def __init__(self, out, *a, **k):
                super().__init__(_EditedOut(out, edit), *a, **k)
        probes._set(mod, "SamWriter", EditedWriter)
