"""64-bit integer hash used for deterministic tie-breaking.

This is Thomas Wang's 64-bit mix hash, reproduced with explicit 64-bit
wrapping semantics so Python big-ints behave exactly like C uint64_t
(reference: software/utils.h:99-110).  The hash keys every
secondary-alignment and pairing tie-break, so it must match bit-for-bit.
"""

M64 = (1 << 64) - 1


def hash_64(key: int) -> int:
    key &= M64
    key = (key + (~(key << 32) & M64)) & M64
    key ^= key >> 22
    key = (key + (~(key << 13) & M64)) & M64
    key ^= key >> 8
    key = (key + (key << 3)) & M64
    key ^= key >> 15
    key = (key + (~(key << 27) & M64)) & M64
    key ^= key >> 31
    return key
