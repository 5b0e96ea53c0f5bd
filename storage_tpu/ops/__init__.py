"""Algorithm kernels: decision sets, inventory-space reduction, ratchet and
grid interpolation, regression (the array re-design of ``StorageHelper.cs``)."""
