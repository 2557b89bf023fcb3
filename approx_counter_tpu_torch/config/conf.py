"""Config-file parser.

Exact grammar of the reference's ``parse_config``
(approx_counter.cpp:103-135):

  * one ``key=value`` per line
  * a ``#`` as the *first character* of a line marks a comment (a ``#``
    anywhere else is data)
  * **all** spaces are stripped, before and after ``=`` -- even inside
    values, so paths with spaces are unsupported (reference quirk, kept)
  * a line without ``=`` yields key=line, value="" (kept)
  * missing/unopenable file -> warning to stderr, empty map, continue
"""

from __future__ import annotations

import sys


def parse_config(path: str) -> dict[str, str]:
    params: dict[str, str] = {}
    try:
        f = open(path, "r")
    except OSError:
        sys.stderr.write("/!\\ WARNING: Could not open config file\n")
        return params
    with f:
        text = f.read()
        lines = text.split("\n")
        if lines and lines[-1] == "":
            lines.pop()  # std::getline yields no record for a trailing \n
        for line in lines:
            # C++ reads line[0] of a possibly-empty string; emulate: empty
            # lines fall through and produce params[""] = "" like the ref.
            if line[:1] == "#":
                continue
            arg = ""
            val = ""
            sep = False
            for c in line:
                if c == "=":
                    sep = True
                elif c != " ":
                    if sep:
                        val += c
                    else:
                        arg += c
            params[arg] = val
    return params
