"""utils/vcfcmp.py: the --no-exact tolerance contract."""

import pytest

from bs_call_tpu.utils import vcfcmp

HEADER = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"


def _row(pos, gt="0/0", gl="-0.328846,-3.3012", dp="3"):
    return (f"chr1\t{pos}\t.\tA\t.\t2\tPASS\t.\t"
            f"GT:FT:DP:GL:MC8:CS:CG:CX\t{gt}:PASS:{dp}:{gl}:0,1:+:N:ACGTA")


def _vcf(rows):
    return HEADER + "\n".join(rows) + "\n"


WANT = _vcf([_row(p) for p in range(1, 20001)])


@pytest.mark.parametrize("unit, s", [
    (1e-6, "-0.328846"), (1e-4, "-3.3012"), (1e-11, "-9.96537e-06"),
    (1e-3, "-99.999"), (1.0, "-2"),
])
def test_last_digit_unit(unit, s):
    assert vcfcmp.last_digit_unit(s) == pytest.approx(unit)


@pytest.mark.parametrize("got, equal, ok", [
    (WANT, 20000, True),
    # one GL digit off by one unit: within tolerance
    (WANT.replace("-0.328846", "-0.328847", 1), 20000, True),
    # a missing row and two flipped calls: 3 of 20000 rows (> 1e-4)
    (_vcf([_row(p, gt="0/1" if p in (7, 8) else "0/0")
           for p in range(2, 20001)]), 19997, False),
    # one flipped call: 1 of 20000 rows (within 1e-4)
    (WANT.replace("0/0:PASS", "0/1:PASS", 1), 19999, True),
    # a GL far outside the tolerance on an otherwise equal row
    (WANT.replace("-3.3012", "-3.3112", 1), 20000, False),
    # DP differs: the row is unequal
    (WANT.replace(":PASS:3:", ":PASS:4:", 1), 19999, True),
], ids=["same", "gl_one_unit", "missing_and_flipped", "one_flip",
        "gl_far", "dp_differs"])
def test_compare(got, equal, ok):
    r = vcfcmp.compare(got, WANT)
    assert r["rows"] == 20000
    assert r["equal"] == equal
    assert r["ok"] is ok


def test_small_winner_gl_relative_tolerance():
    # 2 units at 6 digits on a small winner GL: inside 1e-5 relative
    assert vcfcmp.gl_close("-9.96537e-06", "-9.96535e-06")
    assert not vcfcmp.gl_close("-9.96537e-06", "-9.96437e-06")
    assert not vcfcmp.gl_close("-1,-2", "-1")
