"""Compact SRA accession codec (sra_accession.h/.cpp).

An accession like "SRR1234567" (3 letters + 1..10 digits) packs into a
uint64: low 4 bits store ``num_digits - 1``; the payload above them is the
mixed-radix value ``((L0*26 + L1)*26 + L2) * 10**num_digits + digits``
accumulated in scan order (letters base-26, digits base-10),
reproducing sra_accession.cpp:27-96. Zero is the invalid sentinel.
"""

from __future__ import annotations

_LETTER = 26
_DIGIT = 10
_NUM_LETTERS = 3
_MAX_NUM_DIGITS = 10

INVALID_ACCESSION = 0


_POW10 = tuple(10 ** i for i in range(_MAX_NUM_DIGITS + 1))


def str_to_accession(accession: str) -> int:
    # Fast path: the NCBI shape, 3 ASCII uppercase letters + 1..10 ASCII
    # digits ("SRR1234567") -- identical packing to the general loop.
    if 4 <= len(accession) <= 13 and accession.isascii():
        p, d = accession[:3], accession[3:]
        if p.isalpha() and p.isupper() and d.isdigit():
            nd = len(d)
            data = ((ord(p[0]) - 65) * 26 + (ord(p[1]) - 65)) * 26 + (
                ord(p[2]) - 65)
            ret = (nd - 1) | ((data * _POW10[nd] + int(d)) << 4)
            if ret != INVALID_ACCESSION:
                return ret
    num_letter = 0
    num_digit = 0
    data = 0
    for ch in accession:
        u = ch.upper()
        if "A" <= u <= "Z":
            num_letter += 1
            data = data * _LETTER + (ord(u) - ord("A"))
        elif "0" <= ch <= "9":
            num_digit += 1
            data = data * _DIGIT + (ord(ch) - ord("0"))
        # other characters are skipped, as in the reference switch
    if num_letter != _NUM_LETTERS or num_digit == 0 or num_digit > _MAX_NUM_DIGITS:
        raise ValueError(f"unable to parse accession string {accession!r}")
    ret = (num_digit - 1) | (data << 4)
    if ret == INVALID_ACCESSION:
        raise ValueError("mapped input string to INVALID_ACCESSION")
    return ret & 0xFFFFFFFFFFFFFFFF


def accession_to_str(accession: int) -> str:
    num_digit = (accession & 0xF) + 1
    data = (accession >> 4) & 0x0FFFFFFFFFFFFFFF
    out = []
    for _ in range(num_digit):
        out.append(chr(data % _DIGIT + ord("0")))
        data //= _DIGIT
    for _ in range(_NUM_LETTERS):
        out.append(chr(data % _LETTER + ord("A")))
        data //= _LETTER
    return "".join(reversed(out))
