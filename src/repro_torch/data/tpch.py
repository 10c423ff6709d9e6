"""Schema-faithful synthetic TPC-H generator + query workload.

A copy of ``repro.data.tpch``: the same seed gives the same tables,
queries, partitions and ``file_rows``.

The paper evaluates on TPC-H 1GB / 100GB / 1TB (uniform) and a Zipf-skewed
variant (skew factor 3). The generator rebuilds the 8
TPC-H tables at a configurable row scale, optionally Zipf-skewing the foreign
keys and value columns, and approximate the 22 query templates with 22
parameterized selection/join patterns over the same schema. A "query family"
(paper §VI-A) is the set of table *files* (row chunks) a query touches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.tables import Table

SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"])
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"])
SHIPMODES = np.array(["AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB", "REG AIR"])
STATUSES = np.array(["F", "O", "P"])
NATIONS = np.array(["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
                    "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
                    "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA",
                    "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
                    "UNITED STATES"])
REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
TYPES = np.array([f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                                           "ECONOMY", "PROMO")
                  for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
                  for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")])


def _zipf_idx(rng, n_values: int, size: int, skew: float) -> np.ndarray:
    if skew <= 0:
        return rng.integers(0, n_values, size)
    ranks = np.arange(1, n_values + 1, dtype=np.float64)
    p = ranks ** (-skew)
    p /= p.sum()
    return rng.choice(n_values, size=size, p=p)


@dataclasses.dataclass
class TPCH:
    tables: Dict[str, Table]
    scale_rows: int
    skew: float


def generate(scale_rows: int = 6000, skew: float = 0.0, seed: int = 0) -> TPCH:
    """Generate the 8 TPC-H tables. ``scale_rows`` = lineitem rows (SF1=6M)."""
    rng = np.random.default_rng(seed)
    n_li = scale_rows
    n_ord = max(scale_rows // 4, 10)
    n_cust = max(scale_rows // 40, 10)
    n_part = max(scale_rows // 30, 10)
    n_supp = max(scale_rows // 600, 5)
    n_ps = n_part * 4

    def dates(n, lo=8035, hi=10591):  # days since epoch ~1992..1998
        return rng.integers(lo, hi, n).astype(np.int64)

    region = Table("region", {
        "r_regionkey": np.arange(len(REGIONS)),
        "r_name": REGIONS.copy(),
    })
    nation = Table("nation", {
        "n_nationkey": np.arange(len(NATIONS)),
        "n_name": NATIONS.copy(),
        "n_regionkey": rng.integers(0, len(REGIONS), len(NATIONS)),
    })
    supplier = Table("supplier", {
        "s_suppkey": np.arange(n_supp),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(n_supp)]),
        "s_nationkey": rng.integers(0, len(NATIONS), n_supp),
        "s_acctbal": np.round(rng.uniform(-999, 9999, n_supp), 2),
    })
    part = Table("part", {
        "p_partkey": np.arange(n_part),
        "p_name": np.array([f"part {i % 97} brand{i % 13}" for i in range(n_part)]),
        "p_type": TYPES[_zipf_idx(rng, len(TYPES), n_part, skew)],
        "p_size": rng.integers(1, 51, n_part),
        "p_retailprice": np.round(900 + (np.arange(n_part) % 1000) * 1.0, 2),
    })
    partsupp = Table("partsupp", {
        "ps_partkey": np.repeat(np.arange(n_part), 4)[:n_ps],
        "ps_suppkey": rng.integers(0, n_supp, n_ps),
        "ps_availqty": rng.integers(1, 10000, n_ps),
        "ps_supplycost": np.round(rng.uniform(1, 1000, n_ps), 2),
    })
    customer = Table("customer", {
        "c_custkey": np.arange(n_cust),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(n_cust)]),
        "c_nationkey": rng.integers(0, len(NATIONS), n_cust),
        "c_acctbal": np.round(rng.uniform(-999, 9999, n_cust), 2),
        "c_mktsegment": SEGMENTS[_zipf_idx(rng, len(SEGMENTS), n_cust, skew)],
    })
    orders = Table("orders", {
        "o_orderkey": np.arange(n_ord),
        "o_custkey": _zipf_idx(rng, n_cust, n_ord, skew),
        "o_orderstatus": STATUSES[rng.integers(0, 3, n_ord)],
        "o_totalprice": np.round(rng.gamma(2.0, 60000, n_ord), 2),
        "o_orderdate": dates(n_ord),
        "o_orderpriority": PRIORITIES[_zipf_idx(rng, len(PRIORITIES), n_ord, skew)],
    })
    li_order = _zipf_idx(rng, n_ord, n_li, skew)
    shipdate = orders.columns["o_orderdate"][li_order] + rng.integers(1, 121, n_li)
    lineitem = Table("lineitem", {
        "l_orderkey": li_order,
        "l_partkey": _zipf_idx(rng, n_part, n_li, skew),
        "l_suppkey": rng.integers(0, n_supp, n_li),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.int64),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n_li), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n_li), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n_li), 2),
        "l_returnflag": np.array(["A", "N", "R"])[rng.integers(0, 3, n_li)],
        "l_shipdate": shipdate,
        "l_shipmode": SHIPMODES[_zipf_idx(rng, len(SHIPMODES), n_li, skew)],
    })
    # data lakes ingest time-ordered events (paper §VI-B): cluster the fact
    # tables by date so range queries touch contiguous file subsets
    lineitem = lineitem.sort_by("l_shipdate")
    orders = orders.sort_by("o_orderdate")
    return TPCH({t.name: t for t in (region, nation, supplier, part, partsupp,
                                     customer, orders, lineitem)},
                scale_rows, skew)


# --------------------------------------------------------------------- files
def chunk_files(db: TPCH, rows_per_file: int = 500) -> Dict[str, List[Tuple[str, np.ndarray]]]:
    """Split each table into 'files' (contiguous row chunks) — the unit of
    storage and of DATAPART partitioning. Returns table -> [(file_id, row_idx)]."""
    out: Dict[str, List[Tuple[str, np.ndarray]]] = {}
    for name, t in db.tables.items():
        n = t.num_rows
        files = []
        for i, lo in enumerate(range(0, n, rows_per_file)):
            idx = np.arange(lo, min(lo + rows_per_file, n))
            files.append((f"{name}/{i:05d}", idx))
        out[name] = files
    return out


# -------------------------------------------------------------------- queries
# 22 parameterized patterns over the schema: (table, predicate-builder).
def _q_templates():
    def date_range(col, lo, hi):
        return lambda t, rng: (t.columns[col] >= lo + rng.integers(0, 200)) & \
                              (t.columns[col] < hi + rng.integers(0, 200))

    def eq_choice(col, values):
        return lambda t, rng: t.columns[col] == values[rng.integers(0, len(values))]

    def num_range(col, lo, hi, width):
        def f(t, rng):
            a = rng.uniform(lo, hi - width)
            return (t.columns[col] >= a) & (t.columns[col] < a + width)
        return f

    T = []
    # Q1/Q6-style lineitem date-range scans
    for k in range(6):
        T.append(("lineitem", date_range("l_shipdate", 8035 + 360 * k, 8035 + 360 * (k + 1))))
    # shipmode / returnflag selections (Q12-like)
    T.append(("lineitem", eq_choice("l_shipmode", SHIPMODES)))
    T.append(("lineitem", eq_choice("l_returnflag", np.array(["A", "N", "R"]))))
    # quantity / price bands (Q19-like)
    T.append(("lineitem", num_range("l_quantity", 1, 50, 5)))
    T.append(("lineitem", num_range("l_extendedprice", 900, 105000, 9000)))
    # orders patterns (Q3/Q4/Q5-like)
    for k in range(4):
        T.append(("orders", date_range("o_orderdate", 8035 + 500 * k, 8035 + 500 * (k + 1))))
    T.append(("orders", eq_choice("o_orderpriority", PRIORITIES)))
    T.append(("orders", num_range("o_totalprice", 1000, 400000, 40000)))
    # customer segment scans (Q3/Q10-like)
    T.append(("customer", eq_choice("c_mktsegment", SEGMENTS)))
    T.append(("customer", num_range("c_acctbal", -999, 9999, 1500)))
    # part/type scans (Q2/Q8/Q9-like)
    T.append(("part", eq_choice("p_type", TYPES[:30])))
    T.append(("part", num_range("p_size", 1, 50, 8)))
    # partsupp / supplier scans (Q11/Q15/Q16/Q20-like)
    T.append(("partsupp", num_range("ps_supplycost", 1, 1000, 120)))
    T.append(("supplier", num_range("s_acctbal", -999, 9999, 1800)))
    return T


@dataclasses.dataclass
class Query:
    template_id: int
    table: str
    rows: np.ndarray          # matched row indices in the table
    files: Tuple[str, ...]    # file ids touched


def generate_queries(db: TPCH, n_per_template: int = 20, seed: int = 1,
                     rows_per_file: int = 500,
                     template_skew: float = 0.0) -> List[Query]:
    """Instantiate ``n_per_template`` queries per template (paper: 20 each).

    ``template_skew`` > 0 draws template popularity from a Zipf law instead of
    uniform — the 'skewed query workload' configuration.
    """
    rng = np.random.default_rng(seed)
    templates = _q_templates()
    files = chunk_files(db, rows_per_file)
    total = n_per_template * len(templates)
    if template_skew > 0:
        t_idx = _zipf_idx(rng, len(templates), total, template_skew)
    else:
        t_idx = np.repeat(np.arange(len(templates)), n_per_template)
    queries: List[Query] = []
    for qi, ti in enumerate(t_idx):
        table_name, pred = templates[ti]
        t = db.tables[table_name]
        mask = pred(t, rng)
        rows = np.nonzero(mask)[0]
        touched = tuple(fid for fid, idx in files[table_name]
                        if mask[idx].any())
        queries.append(Query(int(ti), table_name, rows, touched))
    return queries


# ------------------------------------------------------- SCOPe pipeline glue
def build_file_rows(db: TPCH, rows_per_file: int = 500):
    """file_id -> (Table, row_idx) map consumed by scope.run_pipeline."""
    out = {}
    for name, files in chunk_files(db, rows_per_file).items():
        for fid, idx in files:
            out[fid] = (db.tables[name], idx)
    return out


def file_sizes_gb(db: TPCH, rows_per_file: int = 500, layout: str = "col"):
    """file_id -> serialized size (bytes) for DATAPART spans."""
    sizes = {}
    for name, files in chunk_files(db, rows_per_file).items():
        t = db.tables[name]
        for fid, idx in files:
            sizes[fid] = float(t.select(idx).nbytes(layout))
    return sizes


def partitions_from_queries(db: TPCH, queries, rows_per_file: int = 500,
                            layout: str = "col", rho_per_query: float = 24.0):
    """Initial partitions (query families) + file_rows for the pipeline.

    ``rho_per_query``: projected executions of each logged query over the
    billing window (the paper runs its 440-query workload repeatedly over
    5.5 months; ~weekly re-execution = 24).
    """
    from repro_torch.core.datapart import make_partitions
    sizes = file_sizes_gb(db, rows_per_file, layout)
    qf = [(q.files, rho_per_query) for q in queries if q.files]
    parts = make_partitions(qf, sizes)
    return parts, build_file_rows(db, rows_per_file)
