"""The port's catalog against the JAX package's: the same seed gives the
same columns, bit for bit, the same key domains and the same column
statistics; and ``catalog_from_numpy`` rebuilds a JAX catalog's data in the
port."""

import dataclasses

import numpy as np
import pytest

from repro.sql import datagen as jdatagen
from repro_torch.sql import datagen


def assert_catalogs_equal(jcat, tcat):
    assert tcat.p == jcat.p
    assert sorted(tcat.tables) == sorted(jcat.tables)
    for name, jt in jcat.tables.items():
        tt = tcat.tables[name]
        assert list(tt.columns) == list(jt.columns), name
        np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
        for col, c in jt.columns.items():
            got = tt.columns[col].numpy()
            assert got.dtype == np.asarray(c).dtype, col
            np.testing.assert_array_equal(got, np.asarray(c), col)
    assert tcat.key_domains == jcat.key_domains
    assert sorted(tcat.column_stats) == sorted(jcat.column_stats)
    for col, cs in jcat.column_stats.items():
        assert (dataclasses.asdict(tcat.column_stats[col])
                == dataclasses.asdict(cs)), col


@pytest.fixture(scope="module")
def port_catalog():
    return datagen.generate(0.1, 4, 42, device="cpu")


def test_generate_equals_reference(catalog, port_catalog):
    assert_catalogs_equal(catalog, port_catalog)


def test_generate_scales_only_facts(port_catalog):
    rows = {n: t.count() for n, t in port_catalog.tables.items()}
    assert rows["store_sales"] == 10_000
    assert rows["catalog_sales"] == 6_000
    for dim in datagen.PRIMARY_KEYS:
        assert rows[dim] == datagen.SCHEMA[dim]
    assert datagen.TABLE_COLUMNS == {
        n: tuple(t.columns) for n, t in port_catalog.tables.items()}


def test_skew_overrides_equal_reference():
    kw = dict(scale=0.05, p=4, seed=7, skew=0.6,
              skew_overrides={"ss_customer_sk": 1.4})
    assert_catalogs_equal(jdatagen.generate(**kw),
                          datagen.generate(**kw, device="cpu"))


def test_catalog_from_numpy_rebuilds_reference(catalog):
    tables = {n: t.to_numpy() for n, t in catalog.tables.items()}
    rebuilt = datagen.catalog_from_numpy(tables, catalog.p,
                                         catalog.key_domains, device="cpu")
    assert_catalogs_equal(catalog, rebuilt)


def test_every_catalog_has_its_own_fingerprint(port_catalog):
    other = datagen.generate(0.01, 2, 0, device="cpu")
    assert (datagen.catalog_fingerprint(other)
            != datagen.catalog_fingerprint(port_catalog))
    assert other.version > port_catalog.version
    assert datagen.catalog_fingerprint(object()) == (None, None)


def test_static_tables_equal_reference():
    for name in ("SCHEMA", "FK_DIMENSIONS", "PRIMARY_KEYS", "TABLE_COLUMNS",
                 "COLUMN_DOMAINS", "STATIC_KEY_DOMAINS", "FACTS"):
        assert getattr(datagen, name) == getattr(jdatagen, name), name
