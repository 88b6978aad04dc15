"""MLP residual Huffman codebooks: the decode tree and the encode map.

The benchmark's frozen copy of ``dvda_tpu_torch/codecs/mlp/codebooks.py``.

Reference analogs: the three canonical codebook definitions
src/mlp_codebook{1,2,3}.json and the build-time compiler that turns them
into reader-state jump tables (src/huffman.c:262-418, Makefile:108-115).

The copy keeps what the benchmark's generator and reference use: a
**binary tree** for the bit-by-bit reference reader
(BitReader.read_huffman_code) and an **encode map** (value → (code,
length)) for the MLP stream synthesiser.

Codebook shapes (values are the residual MSBs, mlp.c:1211-1227):
  codebook 1: values 0..17, codes 3..9 bits  (escape/invalid: two 9-bit codes)
  codebook 2: values 0..15, codes 2..9 bits
  codebook 3: values 0..14, codes 1..9 bits
"""

from __future__ import annotations

from functools import lru_cache

__all__ = [
    "CODEBOOKS",
    "decode_tree",
    "encode_map",
    "codebook_value_range",
]

# (code bits as a string, value); value None = invalid/escape code.
# Data from src/mlp_codebook{1,2,3}.json — canonical MLP tables.
CODEBOOKS: dict[int, list[tuple[str, int | None]]] = {
    1: [
        ("111", 10), ("110", 9), ("101", 8), ("100", 7), ("011", 11),
        ("0101", 12), ("01001", 13), ("010001", 14), ("0100001", 15),
        ("01000001", 16), ("010000001", 17), ("010000000", None),
        ("001", 6), ("0001", 5), ("00001", 4), ("000001", 3),
        ("0000001", 2), ("00000001", 1), ("000000001", 0),
        ("000000000", None),
    ],
    2: [
        ("11", 8), ("10", 7), ("011", 9), ("0101", 10), ("01001", 11),
        ("010001", 12), ("0100001", 13), ("01000001", 14), ("010000001", 15),
        ("010000000", None),
        ("001", 6), ("0001", 5), ("00001", 4), ("000001", 3),
        ("0000001", 2), ("00000001", 1), ("000000001", 0),
        ("000000000", None),
    ],
    3: [
        ("1", 7), ("011", 8), ("0101", 9), ("01001", 10), ("010001", 11),
        ("0100001", 12), ("01000001", 13), ("010000001", 14),
        ("010000000", None),
        ("001", 6), ("0001", 5), ("00001", 4), ("000001", 3),
        ("0000001", 2), ("00000001", 1), ("000000001", 0),
        ("000000000", None),
    ],
}


@lru_cache(maxsize=None)
def decode_tree(codebook: int):
    """Compile a codebook to a nested-tuple binary tree for the Python
    bit reader.  Nodes are [zero, one] pairs; leaves are values or None."""

    def insert(node: list, code: str, value):
        bit = int(code[0])
        if len(code) == 1:
            node[bit] = value
        else:
            if not isinstance(node[bit], list):
                node[bit] = [None, None]
            insert(node[bit], code[1:], value)

    root: list = [None, None]
    for code, value in CODEBOOKS[codebook]:
        insert(root, code, value)

    def freeze(node):
        if isinstance(node, list):
            return (freeze(node[0]), freeze(node[1]))
        return node

    return freeze(root)


@lru_cache(maxsize=None)
def encode_map(codebook: int) -> dict[int, tuple[int, int]]:
    """value → (code_bits, code_length), for the test-stream synthesiser."""
    out = {}
    for code, value in CODEBOOKS[codebook]:
        if value is not None:
            out[value] = (int(code, 2), len(code))
    return out


def codebook_value_range(codebook: int) -> tuple[int, int]:
    """Inclusive (min, max) encodable MSB for a codebook."""
    vals = [v for _, v in CODEBOOKS[codebook] if v is not None]
    return min(vals), max(vals)
