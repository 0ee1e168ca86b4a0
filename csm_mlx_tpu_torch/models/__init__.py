"""Models of the port: the Llama stack, CSM and the Mimi codec."""
