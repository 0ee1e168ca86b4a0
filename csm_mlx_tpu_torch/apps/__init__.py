"""Applications: the voice chat (`voice_chat`) and its streaming STT
(`stt`)."""
