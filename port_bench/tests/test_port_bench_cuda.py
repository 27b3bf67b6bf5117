"""On the card (marker `cuda`; skips without one): one cell of each
driver at its own size, the program against the reference within the
cell's limits and the float8 control past at least one of them.

    python -m pytest port_bench/tests -m cuda -p no:cacheprovider
"""

import pytest

import _smoke  # noqa: F401
from port_bench import core


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["celeba128.serve-b32", "celeba128.train-b16"])
def test_control_at_the_cells_size(cell_name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell, config = core.load_cell(cell_name)
    run = core.Run(cell_name, cell, config, 2 ** 31 + 99, 1.0, False,
                   cache=core.BENCH_DIR / "cache", control=True)
    rec = core.load_driver(cell["traffic"]["driver"]).run(run)
    limits = cell["limits"]
    assert all(rec["numbers"][k] <= v for k, v in limits.items()), rec["numbers"]
    assert any(rec["control"][k] > v for k, v in limits.items()), rec["control"]
