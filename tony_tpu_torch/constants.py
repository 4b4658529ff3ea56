"""The names the port's history files share with the JAX package's
(``tony_tpu/constants.py:100-108``): a history directory written by
either package reads in the other's portal."""

from __future__ import annotations

TONY_FINAL_CONF = "tony-final.json"  # merged conf shipped to coord + agents
HISTORY_INTERMEDIATE = "intermediate"
HISTORY_FINISHED = "finished"
JHIST_SUFFIX = ".jhist.jsonl"  # event-log container (jsonl in place of Avro)
INPROGRESS_SUFFIX = ".inprogress"
METADATA_FILE = "metadata.json"
