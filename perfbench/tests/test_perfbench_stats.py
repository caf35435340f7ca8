"""The benchmark's column statistics, computed on the catalog's device,
equal ``repro_torch.sql.datagen.compute_column_stats`` on the same
tables."""

import json

import _paths
import pytest
import torch

from perfbench import datagen

CONFIG = json.loads((_paths.ROOT / "perfbench" / "configs" / "tpcds_sf1.json")
                    .read_text())


@pytest.mark.parametrize("seed", (1, 2**31 + 3))
def test_column_stats_equal_the_programs(seed):
    from repro_torch.joins.table import Table
    from repro_torch.sql.datagen import compute_column_stats

    tables = datagen.base_tables(CONFIG, seed, "cpu", 0.005)
    # The calendar tables' 160,000 rows hold nothing the others lack.
    tables = {t: c for t, c in tables.items()
              if t not in ("date_dim", "time_dim")}
    flat = {name: Table(dict(cols), torch.ones(
        next(iter(cols.values())).numel(), dtype=torch.bool))
        for name, cols in tables.items()}
    want = compute_column_stats(flat)
    got = {c: datagen.column_stats(t) for cols in tables.values()
           for c, t in cols.items()}
    assert got.keys() == want.keys()
    for col in want:
        assert got[col] == want[col], col


def test_the_catalog_holds_them_and_the_seed_fixes_the_data():
    a = datagen.base_tables(CONFIG, 9, "cpu", 0.005)
    b = datagen.base_tables(CONFIG, 9, "cpu", 0.005)
    c = datagen.base_tables(CONFIG, 10, "cpu", 0.005)
    for t in a:
        for col in a[t]:
            assert torch.equal(a[t][col], b[t][col])
    assert not torch.equal(a["store_sales"]["ss_sales_price"],
                           c["store_sales"]["ss_sales_price"])
    # The dimensions are the deployment's: the seed draws only the facts.
    assert torch.equal(a["customer"]["c_birth_year"],
                       c["customer"]["c_birth_year"])
    cat = datagen.catalog(a, 8, datagen.key_domains(CONFIG, 0.005))
    assert cat.column_stats["ss_customer_sk"] == \
        datagen.column_stats(a["store_sales"]["ss_customer_sk"])
    assert cat.tables["store_sales"].count() == \
        a["store_sales"]["ss_item_sk"].numel()


@pytest.mark.parametrize("name", ("tpcds_sf1", "tpcds_sf10"))
def test_every_table_has_the_specified_rows_and_columns(name):
    """The row counts are the configuration's and every column of the
    schema is drawn (the full SF1 and SF10 counts, checked without
    drawing them)."""
    cfg = json.loads((_paths.ROOT / "perfbench" / "configs" / f"{name}.json")
                     .read_text())
    schema = datagen.load_schema(cfg["schema"])
    assert set(cfg["rows"]) == set(schema["tables"])
    assert sum(len(c) for c in schema["tables"].values()) == 425
    assert datagen.table_rows(cfg, schema) == cfg["rows"]
    tables = datagen.base_tables(cfg, 1, "cpu", 0.001)
    for t, cols in schema["tables"].items():
        assert list(tables[t]) == [c.split()[0] for c in cols], t
