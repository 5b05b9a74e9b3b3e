"""The GPU decode engine: staging, the parse-and-pack kernel and its
plain version, the DeviceDecoder and the pipelined decode scheduler."""
