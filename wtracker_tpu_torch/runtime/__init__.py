"""Native runtime components (C++ via ctypes): parallel BMP frame decoding."""
