"""Payload that writes the command lines of its ancestors up to the
coordinator (its shell, the agent, the coordinator) to ``$LINEAGE_OUT``,
one per line, nearest first; imports nothing of either package."""

import os


def parent(pid: int) -> int:
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[1])


def cmdline(pid: int) -> str:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().replace(b"\0", b" ").decode(errors="replace").strip()


lines, pid = [], os.getpid()
for _ in range(6):
    pid = parent(pid)
    if pid <= 1:
        break
    lines.append(cmdline(pid))
    if "coordinator" in lines[-1]:
        break
with open(os.environ["LINEAGE_OUT"], "w") as f:
    f.write("\n".join(lines) + "\n")
