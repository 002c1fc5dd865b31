"""kwage: a JAX k-mer warehousing engine.

A from-scratch JAX/XLA re-design of the capabilities of
LANL-Bioinformatics/KWAGE (BIGSI-style bit-sliced Bloom-filter sequence
search over sequence-read archives):

- ``kwage.core``   -- host-side numerics (2-bit k-mer codec, murmur3-32,
  Bloom parameter solver, SRA accession codec, metadata records).
- ``kwage.io``     -- byte-exact readers/writers for the ``.bloom``,
  ``.db``, binary-inventory and status-file formats, plus FASTA/FASTQ and
  streaming tar readers.
- ``kwage.ops``    -- device compute: vectorized k-mer extraction,
  seed-vectorized hashing, counting/thresholding, the filter->bit-slice
  transpose, and the dense AND-reduce search kernel (plain XLA).
- ``kwage.parallel`` -- multi-device sharding (mesh/shard_map) and the
  maestro host-side scheduler with checkpoint/restart.
- ``kwage.pipeline`` -- end-to-end flows (accession -> Bloom filter ->
  database -> search; SriRachA-style per-read confirmation).
- ``kwage.cli``    -- command-line tools mirroring the reference suite.

Version identifiers mirror the reference (kwage.h:4-6) for output parity.
"""

KWAGE_VERSION = "0.4d"
INVENTORY_VERSION = "0.7"
MAESTRO_VERSION = "0.9"
SRIRACHA_VERSION = "0.43"
