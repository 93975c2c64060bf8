"""Hit-list rendering, byte-identical to the reference (output.h).

Formatting quirks reproduced deliberately:

- CSV percent uses float32 arithmetic ``(100.0f*nf)*float32(1/nq)`` printed
  with C++ default stream formatting (6 significant digits, %g semantics).
- JSON sets ``showpoint << setprecision(1) << fixed`` for the threshold and
  those manipulators persist for the rest of the stream, so every
  percent_kmers_found also prints with exactly one fixed decimal. The JSON
  percent itself is ``double(100.0*nf) * double(float32(1/nq))``.
- The JSON array brackets/indent appear only when more than one query
  matched (kwage.cpp:204-219; output.h:61-112).
"""

from __future__ import annotations

import numpy as np

from .engine import MatchResult


def _float32_norm(num_query_kmer: int) -> np.float32:
    return np.float32(1.0) / np.float32(num_query_kmer) if num_query_kmer else np.float32(0.0)


def _cpp_default_float(x: float) -> str:
    """C++ default ostream float formatting (precision 6, %g semantics)."""
    return f"{x:g}"


def render_csv(query_results: list[tuple[str, list[MatchResult]]]) -> str:
    out = ["query,num_kmers,num_kmers_found,percent_kmers_found,sample_metadata\n"]
    for query, matches in query_results:
        for m in matches:
            norm = _float32_norm(m.num_query_kmer)
            pct = np.float32(np.float32(100.0) * np.float32(m.num_kmers_found)) * norm
            out.append(
                f'"{query}",{m.num_query_kmer},{m.num_kmers_found},'
                f'{_cpp_default_float(float(pct))},"{m.subject_info.csv_string()}"\n'
            )
    return "".join(out)


def _render_json_query(
    query: str,
    matches: list[MatchResult],
    multiple: bool,
    first: bool,
    threshold: float,
) -> str:
    prefix = "\t" if multiple else ""
    out = []
    out.append("," if (multiple and not first) else "")
    out.append(f'\n{prefix}{{\n{prefix}\t"query": "{query}",\n{prefix}')
    out.append(f'\t"threshold": {float(np.float32(threshold)):.1f},\n{prefix}\t"results": [')
    for i, m in enumerate(matches):
        norm = float(_float32_norm(m.num_query_kmer))
        pct = (100.0 * m.num_kmers_found) * norm
        out.append("," if i else "")
        out.append(
            f'\n{prefix}\t\t{{\n{prefix}\t\t\t"percent_kmers_found": {pct:.1f},'
            f'\n{prefix}\t\t\t"num_kmers": {m.num_query_kmer},'
            f'\n{prefix}\t\t\t"num_kmers_found": {m.num_kmers_found},'
            f'\n{prefix}\t\t\t"sample_metadata": {{\n'
            f'{m.subject_info.json_string(prefix + chr(9) * 4)}'
            f"\n{prefix}\t\t\t}}\n{prefix}\t\t}}"
        )
    if matches:
        out.append(f"\n{prefix}\t")
    out.append(f"]\n{prefix}}}")
    return "".join(out)


def render_json(
    query_results: list[tuple[str, list[MatchResult]]], threshold: float
) -> str:
    multiple = len(query_results) > 1
    out = []
    if multiple:
        out.append("[")
    first = True
    for query, matches in query_results:
        out.append(_render_json_query(query, matches, multiple, first, threshold))
        first = False
    if multiple:
        out.append("\n]\n")
    return "".join(out)
