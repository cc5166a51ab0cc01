"""Step 4, the assembly layer (reference: src/scripts/* + src/clustering.py).

Copied from pangaea_tpu.asm with the imports renamed: bin assembly, read
mapback, low-abundance recovery and reassembly, merge_olc, quickmerge and
circularization, with their external tools when on PATH and built-in
fallbacks otherwise. The one device module is ``mapper`` (the k-mer vote
mapper, whose run-length scan is the CUDA ``cummax``); everything else is
host Python and numpy. ``diversity`` is the metaphlan Shannon estimate
of the cluster count, with the rest of the reference's diversity metrics.
"""
