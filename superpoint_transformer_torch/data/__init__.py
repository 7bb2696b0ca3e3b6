"""Host containers (Data, NAG, CSR clusters, HDF5 files), batching and
padding on the host, and the padded batch on a device."""
