"""The port's PostGIS baseline driver against the JAX package's: the SQL of
every cell of the paper's grid, the LaTeX rows and the missing-driver
error, equal as strings. No database is needed."""

import importlib

import pytest

from adhoc_queries_pointclouds_tpu import experiments as jax_exp
from adhoc_queries_pointclouds_tpu import postgis as jax_pg
from adhoc_queries_pointclouds_torch import experiments as torch_exp
from adhoc_queries_pointclouds_torch import postgis as torch_pg

GRID = [(d, s) for d in ("navvis3", "doc", "ca13") for s in ("s", "l", "xl")]


def test_tables_and_sizes_equal_the_jax_modules():
    assert torch_pg.TABLE_NAMES == jax_pg.TABLE_NAMES
    assert torch_pg.DATASET_MPTS == jax_pg.DATASET_MPTS


@pytest.mark.parametrize("dataset, size", GRID)
def test_bbox_sql_equals_the_jax_modules(dataset, size):
    table = torch_pg.TABLE_NAMES[dataset]
    ours, theirs = torch_exp.AABBS[dataset][size], jax_exp.AABBS[dataset][size]
    for fn in ("patch_bbox_sql", "exact_bbox_sql"):
        got = getattr(torch_pg, fn)(table, ours)
        assert got == getattr(jax_pg, fn)(table, theirs)
        assert got.startswith("SELECT sum(PC_NumPoints(") and f" FROM {table} " in got


@pytest.mark.parametrize("dataset", ["doc", "ca13"])
@pytest.mark.parametrize("value", [6, 19])
def test_class_sql_equals_the_jax_modules(dataset, value):
    table = torch_pg.TABLE_NAMES[dataset]
    assert torch_pg.class_sql(table, value) == jax_pg.class_sql(table, value)


@pytest.mark.parametrize("dataset", ["navvis3", "doc", "ca13"])
@pytest.mark.parametrize("times", [[2.0, 1.0, 3.0, 1.0, 2.0], [0.5], [0.0, 0.0], [1e-3, 7.25, 0.3]])
def test_latex_row_equals_the_jax_modules(dataset, times):
    name = f"{dataset}\\_s\\_exact"
    assert torch_pg.latex_row(name, dataset, times) == jax_pg.latex_row(name, dataset, times)


def test_missing_driver_error_equals_the_jax_modules(monkeypatch):
    def no_module(name, *args, **kwargs):
        raise ImportError(f"No module named '{name}'")

    monkeypatch.setattr(importlib, "import_module", no_module)
    errors = []
    for pg in (jax_pg, torch_pg):
        with pytest.raises(RuntimeError) as err:
            pg.main(["--host", "h", "--dbname", "d", "--user", "u", "--pwd", "p"])
        errors.append(str(err.value))
    assert errors[1] == errors[0]
    assert errors[1].startswith("No PostgreSQL driver available (psycopg2/psycopg/pg8000).")
