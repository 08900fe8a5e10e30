"""The batched sketcher and the ANI comparator."""
