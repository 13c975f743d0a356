"""The native C++ runtime of `native/mm2tpu_native.cpp`, built and bound
by the port itself (`lib`)."""
