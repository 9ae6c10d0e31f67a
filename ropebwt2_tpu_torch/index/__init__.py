"""Index structures of the flat int8 tier: the buffer and its rank table
(flat, rank), the merge (merge, merge_cuda) and the pending side index
(pending, pending_cuda)."""
