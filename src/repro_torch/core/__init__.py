"""MATADOR core: the Tsetlin Machine config, bit packing and the compiler."""
