"""step_mfu (%): the whole step's share of the chip's peak: the
operations of one image's forward from the configuration's shapes
(``benchmark/arch/<architecture>.forward_flops``), times the window's
images per second, over the peak of the datapath the configuration names
(``benchmark/peaks.py``)."""

from benchmark import peaks


def read(run):
    if not run.win["images"]:
        return None
    rate = run.win["images"] / run.win["wall_s"]
    flops = run.cell.arch.forward_flops(run.config["model"])
    return 100.0 * rate * flops / peaks.OPS_PER_S[run.config["datapath"]]
