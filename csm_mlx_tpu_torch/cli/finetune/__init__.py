"""`finetune` sub-commands of the port's CLI: `full` and `lora` (each
`sft`, `dpo` or `kto`) and `convert`."""
