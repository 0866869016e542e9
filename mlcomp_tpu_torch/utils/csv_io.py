"""Csv tables without pandas, typed and written as pandas types and
writes them (the card's machine has no pandas).

``read_csv(path)`` gives ``{column: np.ndarray}`` in file order: a
column of integers is int64, of numbers float64 (parsed as pandas
parses them, ``pandas_float``; pandas' missing-value words and empty
cells read as NaN, which makes an integer column float64), of
``True``/``False`` bool (objects, with NaN, where a cell is missing),
anything else an object array of str with NaN where a cell is
missing. (Integers past int64, which pandas keeps as uint64 or objects,
read as float64.) ``write_csv(path, columns)``
writes what ``DataFrame(columns).to_csv(path, index=False)`` writes:
floats as their shortest repr, NaN and None as empty cells, quoting as
the csv module's ``QUOTE_MINIMAL``, ``\\n`` line ends.
"""

import csv
import math
import re

import numpy as np

#: ``pandas.read_csv``'s default missing-value words
NA_VALUES = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None',
    'n/a', 'nan', 'null'))
_TRUE, _FALSE = ('True', 'TRUE', 'true'), ('False', 'FALSE', 'false')


def _ints(cells):
    out = []
    for c in cells:
        if '_' in c:        # int() reads 1_000; pandas does not
            return None
        try:
            out.append(int(c))
        except ValueError:
            return None
    return out


_NUMBER = re.compile(r'[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?')
_INF = ('inf', 'infinity')
_POW10 = [float(f'1e{i}') for i in range(309)]


def pandas_float(text: str):
    """The double pandas' C reader makes of ``text`` (its default
    ``precise_xstrtod``: at most 17 significant digits summed in double,
    then one product or quotient by a power of ten; not always the
    nearest double, which Python's ``float`` gives), or None where the
    cell is not a number."""
    t = text.strip()
    if t.lstrip('+-').lower() in _INF and t[:2] not in ('+-', '-+'):
        return float(t)
    m = _NUMBER.fullmatch(t)
    if m is None:
        return None
    negative = t.startswith('-')
    mantissa, _, exp = t.lstrip('+-').replace('E', 'e').partition('e')
    whole, _, frac = mantissa.partition('.')
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    decimals = 0
    for ch in frac:
        if digits >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        decimals += 1
    exponent -= decimals
    if negative:
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _floats(cells):
    out = []
    for c in cells:
        if c in NA_VALUES:
            out.append(math.nan)
            continue
        value = pandas_float(c)
        if value is None:
            return None
        out.append(value)
    return out


_INT64 = (-2 ** 63, 2 ** 63 - 1)


def typed_column(cells) -> np.ndarray:
    """One column's cells (str) as pandas types them."""
    cells = list(cells)
    if not cells:
        return np.asarray([], dtype=object)
    if not any(c in NA_VALUES for c in cells):
        ints = _ints(cells)
        if ints is not None and all(_INT64[0] <= v <= _INT64[1]
                                    for v in ints):
            return np.asarray(ints, np.int64)
        if all(c in _TRUE or c in _FALSE for c in cells):
            return np.asarray([c in _TRUE for c in cells], bool)
    floats = _floats(cells)
    if floats is not None:
        return np.asarray(floats, np.float64)
    if all(c in NA_VALUES or c in _TRUE or c in _FALSE for c in cells):
        # booleans with missing cells: pandas keeps them as objects
        return np.asarray([math.nan if c in NA_VALUES else c in _TRUE
                           for c in cells], dtype=object)
    return np.asarray([math.nan if c in NA_VALUES else c for c in cells],
                      dtype=object)


def read_csv(path: str) -> dict:
    """``{column: typed array}`` of the csv at ``path``."""
    with open(path, newline='') as fh:
        reader = csv.reader(fh)
        header = next(reader, None)
        if header is None:
            raise ValueError(f'{path} is empty: no columns to parse')
        rows = [row for row in reader if row]
    columns = {}
    for i, name in enumerate(header):
        columns[name] = typed_column(
            row[i] if i < len(row) else '' for row in rows)
    return columns


def _cell(value) -> str:
    if value is None:
        return ''
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return '' if math.isnan(value) else repr(float(value))
    return str(value)


def write_csv(path: str, columns: dict):
    """Write ``columns`` ({name: sequence}, equal lengths) as
    ``to_csv(index=False)`` writes a DataFrame of them."""
    names = list(columns)
    n = len(columns[names[0]]) if names else 0
    with open(path, 'w', newline='') as fh:
        writer = csv.writer(fh, lineterminator='\n')
        writer.writerow(names)
        for i in range(n):
            writer.writerow([_cell(columns[k][i]) for k in names])


def n_rows(columns: dict) -> int:
    return len(next(iter(columns.values()))) if columns else 0


__all__ = ['read_csv', 'write_csv', 'typed_column', 'n_rows', 'pandas_float',
           'NA_VALUES']
