"""setup_s: seconds from the harness's start to the first timed solve
(imports, CUDA set-up, the kernel library loaded or built, the instances
drawn, the warm solve)."""


def read(record):
    return record.get("setup_s")
