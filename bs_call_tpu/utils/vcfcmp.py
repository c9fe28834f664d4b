"""Tolerant comparison of two VCF texts, for the float32 (--no-exact)
model against the exact host run.

The float32 model carries an absolute log-likelihood error of about
|ll| * 2^-23 (plus device exp/log, which are not glibc's). A printed GL
value (6 significant digits) therefore moves by about one unit in its last
digit, except the small winner entries (GL = -log10(1 + off), e.g.
-9.96537e-06): there the error of off is relative, ~|ll| * 2^-23, a few
units at 6 digits. A --no-exact call can also, rarely, flip a call or a
filter whose inputs sit at a rounding boundary. The contract checked here:
on at least MIN_EQUAL_FRACTION of the rows (matched by CHROM and POS; a row
present in only one file counts as unequal) the GT/FT/DP/MC8/CS/CG/CX
fields are equal, and on every such row each GL value is within one unit
in the last printed digit, or within GL_REL_TOL relative, of the other's.
"""

from __future__ import annotations

MIN_EQUAL_FRACTION = 0.9999
EXACT_FIELDS = ("GT", "FT", "DP", "MC8", "CS", "CG", "CX")
GL_REL_TOL = 1e-5


def _data(text: str):
    return [ln for ln in text.splitlines() if ln and ln[0] != "#"]


def _key(line: str):
    return tuple(line.split("\t", 2)[:2])


def _fields(line: str) -> dict:
    f = line.split("\t")
    return dict(zip(f[8].split(":"), f[9].split(":")))


def last_digit_unit(s: str) -> float:
    """Value of one unit in the last printed digit of a %g number."""
    mant, _, exp = s.lower().partition("e")
    dec = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - dec)


def gl_close(a: str, b: str) -> bool:
    va, vb = a.split(","), b.split(",")
    if len(va) != len(vb):
        return False
    for x, y in zip(va, vb):
        fx, fy = float(x), float(y)
        tol = max(last_digit_unit(x), last_digit_unit(y),
                  GL_REL_TOL * max(abs(fx), abs(fy)))
        if abs(fx - fy) > tol * (1 + 1e-9):
            return False
    return True


def compare(got: str, want: str) -> dict:
    """Row counts for `got` against `want`: rows (union), equal (exact
    fields equal), gl_bad (equal rows whose GL is outside the tolerance)
    and ok (the contract above holds)."""
    g, w = _data(got), _data(want)
    pairs, g_rest, w_rest = [], {}, {}
    for a, b in zip(g, w):  # rows line up unless a row is missing
        if _key(a) == _key(b):
            pairs.append((a, b))
        else:
            g_rest[_key(a)] = a
            w_rest[_key(b)] = b
    for a in g[len(w):]:
        g_rest[_key(a)] = a
    for b in w[len(g):]:
        w_rest[_key(b)] = b
    both = g_rest.keys() & w_rest.keys()
    pairs += [(g_rest[k], w_rest[k]) for k in both]
    n = len(pairs) + len(g_rest) + len(w_rest) - 2 * len(both)
    equal = gl_bad = 0
    for a, b in pairs:
        if a == b:
            equal += 1
            continue
        fa, fb = _fields(a), _fields(b)
        if all(fa.get(f) == fb.get(f) for f in EXACT_FIELDS):
            equal += 1
            if not gl_close(fa.get("GL", ""), fb.get("GL", "")):
                gl_bad += 1
    return {
        "rows": n,
        "equal": equal,
        "gl_bad": gl_bad,
        "ok": n > 0 and equal >= MIN_EQUAL_FRACTION * n and gl_bad == 0,
    }
