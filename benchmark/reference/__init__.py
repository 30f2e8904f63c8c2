"""Plain references the benchmark holds the port against. They import
torch and numpy only: nothing of the port, of JAX or of the JAX
package."""
