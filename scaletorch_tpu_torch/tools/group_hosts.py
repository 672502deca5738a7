"""Group launch hosts by rack so process ranks follow the topology.

Counterpart of the reference's ``scripts/group_hosts.py``, for the
hosts file ``scaletorch_tpu_torch.tools.launch_hosts`` reads. Ranks are
given in file order, node by node, so hosts that share a rack (or an
NVLink/NVSwitch domain) must be listed together: the mesh axes that
ride the fast links (tp, cp) then stay inside one group. The grammar is
the reference's, one host a line:

    host rack_id             # explicit: "10.0.0.4 rack-a"
    t1v-n-abc123-w-0         # a worker name: the key is the name up to -w-
    # rack-a                 # already-grouped files pass through

Usage (from the root of a checkout):
    python -m scaletorch_tpu_torch.tools.group_hosts hosts.txt
    python -m scaletorch_tpu_torch.tools.group_hosts hosts.txt -o out.txt
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

_WORKER_SUFFIX = re.compile(r"^(?P<slice>.+?)-w-\d+$")


def slice_key(host: str, explicit: str | None = None) -> str:
    """Slice/rack key for a host: an explicit second column wins; TPU-VM
    worker names (``<slice>-w-<n>``) group by their slice prefix;
    anything else is its own group (safe default: no false co-location)."""
    if explicit:
        return explicit
    m = _WORKER_SUFFIX.match(host)
    if m:
        return m.group("slice")
    return host


def group_hosts(lines: List[str]) -> Dict[str, List[str]]:
    """Parse a hosts file's lines into {slice_key: [hosts in input order]}.
    Already-grouped files (``# key`` headers) are re-parsed losslessly."""
    groups: Dict[str, List[str]] = defaultdict(list)
    current: str | None = None
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            current = line.lstrip("#").strip() or None
            continue
        parts = line.split()
        host = parts[0]
        explicit = parts[1] if len(parts) > 1 else current
        groups[slice_key(host, explicit)].append(host)
    return dict(groups)


def render(groups: Dict[str, List[str]]) -> str:
    """Slice-major hosts file with ``# key`` headers; groups ordered by
    first appearance, hosts in input order (stable ranks)."""
    out = []
    for key, hosts in groups.items():
        out.append(f"# {key}")
        out.extend(hosts)
    return "\n".join(out) + "\n"


def rank_assignment(groups: Dict[str, List[str]]) -> List[Tuple[int, str, str]]:
    """(process_rank, host, slice_key) in the slice-major order the
    launcher will use."""
    out = []
    for key, hosts in groups.items():
        for h in hosts:
            out.append((len(out), h, key))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("hosts_file")
    ap.add_argument("-o", "--output", default=None,
                    help="write the grouped file here (default: stdout)")
    args = ap.parse_args()

    with open(args.hosts_file) as f:
        groups = group_hosts(f.readlines())
    text = render(groups)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    n = sum(len(v) for v in groups.values())
    print(f"{n} hosts in {len(groups)} slice groups", file=sys.stderr)


if __name__ == "__main__":
    main()
