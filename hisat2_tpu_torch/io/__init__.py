from .reads import Read, read_fasta, read_fastq, read_reads, read_tab6  # noqa: F401
from .reference import JoinedReference, load_reference  # noqa: F401
