"""Native (C++) runtime components: counterpart of
``directx_raytracer_tpu/native/`` (the ``.crtscene`` parser, ``parser.cpp``
carried byte for byte, built with g++ at first use and bound with
ctypes)."""
