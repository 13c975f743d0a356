"""FASTA/FASTQ reader and PAF/SAM writers: the port's copies of
`mm2tpu/io/`."""
