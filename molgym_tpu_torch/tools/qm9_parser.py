"""QM9 / GDB9 dataset parser (the port's own copy of
molgym_tpu/tools/qm9_parser.py).

Streams (id, Atoms, {smiles}) triples out of the GDB9 tar of extended-xyz
files, including the `*^` -> `E` scientific-notation fixup the raw dataset
needs. run_qm9.py draws its bag set from it.
"""
from __future__ import annotations

import tarfile
from typing import Iterator, Tuple

from molgym_tpu_torch.atoms import Atoms


class ParserError(Exception):
    """Raised when a GDB9 entry cannot be parsed."""


def parse_entry(data: bytes) -> Tuple[str, Atoms, dict]:
    """Parse one GDB9 xyz-like record.

    Layout: natoms line; properties line ('gdb <id> <15 floats>'); natoms
    coordinate lines (element x y z partial-charge); vibrational frequencies;
    two SMILES; two InChIs.
    """
    try:
        lines = data.decode('ascii').splitlines()
        n_atoms = int(lines[0].strip())
        props = lines[1].split()
        if props[0] != 'gdb':
            raise ParserError(f'Unexpected properties line: {lines[1]!r}')
        gdb_id = props[1]

        # full record = natoms + properties + coords + freqs + smiles + inchi;
        # a truncated archive member must be a clean skip, not a non-coord
        # line silently sliding into the coordinate block
        if len(lines) < 2 + n_atoms + 3:
            raise ParserError(f'truncated record: {len(lines)} lines for '
                              f'{n_atoms} atoms')

        symbols, positions = [], []
        for row in lines[2:2 + n_atoms]:
            parts = row.split()
            symbols.append(parts[0])
            positions.append([float(parts[1]), float(parts[2]), float(parts[3])])

        # after coordinates: frequencies line, smiles line, inchi line
        smiles_line = lines[2 + n_atoms + 1].split()
        info = {'smiles': smiles_line[-1]}
        return gdb_id, Atoms(symbols, positions), info
    except (ValueError, KeyError, IndexError, UnicodeDecodeError) as exc:
        # KeyError: a non-element token in the symbol column
        # (Atoms -> periodic.ATOMIC_NUMBERS lookup)
        raise ParserError(str(exc))


def parse_dataset(file_path: str, strict: bool = False
                  ) -> Iterator[Tuple[str, Atoms, dict]]:
    with tarfile.open(file_path, mode='r') as archive:
        for entry in archive:
            f = archive.extractfile(entry)
            if not f:
                raise RuntimeError('File cannot be read')
            data = f.read().replace(b'*^', b'E')
            try:
                yield parse_entry(data)
            except ParserError as exc:
                if strict:
                    raise
                print(f'Could not parse: {entry.name}: {exc}')
