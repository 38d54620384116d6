"""Chemical formula parsing and bag arithmetic (the port's own copy of
molgym_tpu/formula.py). A formula (bag) is a tuple of (atomic_number,
count) pairs."""
from __future__ import annotations

import collections
import re
from typing import Dict, List, Sequence, Tuple

from molgym_tpu_torch.periodic import ATOMIC_NUMBERS, CHEMICAL_SYMBOLS

FormulaType = Tuple[Tuple[int, int], ...]

_TOKEN_RE = re.compile(r'([A-Z][a-z]?)(\d*)|(\()|(\))(\d*)')


def _parse_formula_counts(string: str) -> Dict[str, int]:
    """Parse 'SF6', 'C2H5OH', 'Ca(OH)2' into {symbol: count} (ordered)."""
    pos = 0
    stack: List[collections.OrderedDict] = [collections.OrderedDict()]
    while pos < len(string):
        m = _TOKEN_RE.match(string, pos)
        if not m or m.start() != pos or m.group(0) == '':
            raise ValueError(f'Cannot parse formula: {string!r} at position {pos}')
        if m.group(1):  # element symbol
            symbol = m.group(1)
            if symbol not in ATOMIC_NUMBERS:
                raise ValueError(f'Unknown element {symbol!r} in formula {string!r}')
            count = int(m.group(2)) if m.group(2) else 1
            top = stack[-1]
            top[symbol] = top.get(symbol, 0) + count
        elif m.group(3):  # '('
            stack.append(collections.OrderedDict())
        elif m.group(4):  # ')'
            group = stack.pop()
            mult = int(m.group(5)) if m.group(5) else 1
            if not stack:
                raise ValueError(f'Unbalanced parentheses in formula {string!r}')
            top = stack[-1]
            for symbol, count in group.items():
                top[symbol] = top.get(symbol, 0) + count * mult
        pos = m.end()
    if len(stack) != 1:
        raise ValueError(f'Unbalanced parentheses in formula {string!r}')
    return stack[0]


def string_to_formula(string: str) -> FormulaType:
    counts = _parse_formula_counts(string)
    return tuple((ATOMIC_NUMBERS[symbol], count) for symbol, count in counts.items())


def formula_to_string(formula: FormulaType) -> str:
    return ''.join(f'{CHEMICAL_SYMBOLS[z]}{count if count != 1 else ""}'
                   for z, count in formula if count > 0)


def zs_to_formula(zs: Sequence[int]) -> FormulaType:
    """Atomic numbers -> bag, the elements in the order they first occur."""
    counter: Dict[int, int] = collections.Counter()
    for z in zs:
        counter[int(z)] += 1
    return tuple(counter.items())


def remove_atom_from_formula(formula: FormulaType,
                             atomic_number: int) -> FormulaType:
    out = list(formula)
    for i, (z, count) in enumerate(formula):
        if z == atomic_number and count >= 1:
            out[i] = (z, count - 1)
            return tuple(out)
    raise RuntimeError(f'Could not remove atomic number {atomic_number} '
                       f'from bag {formula}')


def get_formula_size(formula: FormulaType) -> int:
    return sum(count for _z, count in formula)


def split_formula_strings(formulas: str) -> List[str]:
    return formulas.split(',')


def parse_size_range(size_range: str) -> Tuple[int, int]:
    """'4,9' -> (4, 9): sampled bag sizes lo <= size < hi."""
    parts = [int(i) for i in size_range.split(',')]
    if len(parts) != 2:
        raise ValueError(f'size range must be "lo,hi", got {size_range!r}')
    return parts[0], parts[1]
