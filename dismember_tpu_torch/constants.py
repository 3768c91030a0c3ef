"""Framework-wide constants.

Parity notes (reference: the Scala TDM sources):
- ``PADDING_ID``  mirrors ``com.mass.tdm.package.paddingId`` (tdm/src/main/scala/
  com/mass/tdm/package.scala:13): the raw *item id* used to left-pad short user
  sequences in data files.
- ``PADDING_IDX`` mirrors ``paddingIdx`` (same file, line 15): the *embedding
  index* of a padded position.  Embedding lookup of this index yields a zero
  vector and receives no gradient (scalann nn/mixin/LookupTable.scala:10-14).
"""

# Raw item-id used for left padding in persisted sample files.
PADDING_ID = 0

# Embedding index for padded positions (zero vector, no gradient).
PADDING_IDX = -1

# Value used to mask attention scores, mirroring scalann nn/Mask.scala:13
# (maskValue = Float.MinValue).
MASK_VALUE = -3.4028235e38
