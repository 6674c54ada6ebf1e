"""Host C++ components of the port: GIL-free image decode and 16-bit PNG
encode (:mod:`fal_net_torch.native.io`)."""
