"""stolen_per_solve: the mean of ``stats["transferred"]``, the items the
master moved between lanes, over the solves of the window (layer: the
master, ``core/master.superstep``)."""


def read(record):
    moved = [s["transferred"] for s in record["solves"]
             if s["transferred"] is not None]
    return sum(moved) / len(moved) if moved else None
