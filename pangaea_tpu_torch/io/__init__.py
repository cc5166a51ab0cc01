"""Host-side input/output: FASTQ readers, barcode grouping, batch packing,
prefetch, per-bin read extraction, the BAM codec and the read simulator. numpy and pure
Python (copied from pangaea_tpu.io, the parts the port's path uses)."""
